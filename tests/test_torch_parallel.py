"""PyTorch port: ``parallel/`` (the mesh, the tensor-parallel rule, the
sharded train state) against the JAX package's, on the CPU.

Mesh construction and placements need a process group but no peers: they
run in this process under torch's fake backend at JAX's 8-device geometry
(tests/conftest.py gives JAX 8 CPU devices). The sharded steps run in one
group of 2 gloo ranks (``tests/torch_ranks.py``): a data-parallel chunk on
mesh 2 x 1 and tensor-parallel steps on mesh 1 x 2, held against the port's
one-process steps on the same global batch and draws and against JAX's
steps on its 8-device mesh, with JAX's draws passed in.

Tolerances: against JAX, those of tests/test_torch_train.py (loss and
gradient norm rtol 1e-4; parameters and EMA atol 1e-2 x the learning rate)
and relative L2 1e-5 over all parameters; for the 128-channel tensor-parallel
model the elementwise bound is 0.1 x the learning rate: AdamW divides each
gradient by its own scale, so among its 147,456-element kernels an element
whose gradient is near zero moves by a larger share of a step where the
summation order differs (read: 2 elements at 0.053 x the rate, the rest
within 1e-2). Against the one-process port: rtol 1e-5 on the loss, the
gradient norm and the mse, and relative L2 1e-5 on parameters, moments and
EMA (the ranks run one thread and sum in another order; read: 1e-8 on the
parameters, 4e-7 on the moments).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_ranks
from meanflow_audio_codec_tpu.configs import (
    BaseConfig,
    DatasetConfig,
    MethodConfig,
    ModelConfig,
    TPUConfig,
    TrainFlowConfig,
    TrainingConfig,
)
from meanflow_audio_codec_tpu.models import ConditionalConvFlow as JConvFlow
from meanflow_audio_codec_tpu.models import ConditionalMLPMixerFlow as JMixer
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import (
    TrainState as JaxTrainState,
)
from meanflow_audio_codec_tpu.ops.tokenize import (
    create_tokenization_strategy as jax_create_tokenization_strategy,
)
from meanflow_audio_codec_tpu.parallel import batch_sharding as jbatch
from meanflow_audio_codec_tpu.parallel import create_mesh as jcreate_mesh
from meanflow_audio_codec_tpu.parallel import (
    param_partition_spec as jparam_partition_spec,
)
from meanflow_audio_codec_tpu.parallel import shard_state as jshard_state
from meanflow_audio_codec_tpu.training import objectives as jobjectives
from meanflow_audio_codec_tpu.training.trainer import (
    adapter_from_config as jax_adapter_from_config,
)
from meanflow_audio_codec_tpu.training.train_step import (
    make_train_step as jax_make_train_step,
)
from meanflow_audio_codec_tpu.training.trainer import (
    make_optimizer as jax_make_optimizer,
)
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.models.mlp_mixer import (
    ConditionalMLPMixerFlow,
)
from meanflow_audio_codec_torch.ops.tokenize import (
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch.parallel import (
    create_mesh,
    global_batch_slice,
    initialize_distributed,
    mesh_from_config,
    param_partition_spec,
    shard_state,
    state_shardings,
)
from meanflow_audio_codec_torch.parallel.mesh import flax_layout
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.objectives import (
    create_loss_strategy,
)
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

# the geometries of tests/test_parallel.py's tensor-parallel cases
CONV128 = dict(noise_dimension=64, condition_dimension=16, num_blocks=2,
               latent_dimension=16, channels=128, bottleneck_dim=32,
               spatial=8, lift_channels=16)
# one block of it for the steps (the compile of two is JAX's slowest part)
CONV128_STEP = dict(CONV128, num_blocks=1)
MIXER2K = dict(noise_dimension=2048, condition_dimension=16, num_blocks=1,
               latent_dimension=16, token_mix_dim=256, channel_mix_dim=256,
               num_channels=64, num_latent_tokens=4, encoder_context_tokens=8,
               stage_tokens=32, factorized_stages=True)
WINDOW, FRAME_SIZE, BATCH, STEPS = 64, 1024, 8, 2
LR = 1e-3


@pytest.fixture
def fake_world():
    """A fake process group of 8 ranks (this process is rank ``rank``):
    enough for a DeviceMesh, with no peers."""
    def init(rank=0, world=8):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def test_single_process_initialisation_is_a_no_op(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized()
    assert global_batch_slice(16) == (16, 0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_distributed() is False


def test_a_group_that_does_not_form_raises(monkeypatch):
    """A stated departure: JAX's prints the error and returns False (each
    process then trains alone); the port raises."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="rendezvous"):
        initialize_distributed("bogus://nowhere", world_size=2, rank=0,
                               backend="gloo", device="cpu")
    assert not dist.is_initialized()


def test_mesh_construction(fake_world):
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh()
    fake_world()
    mesh = create_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (8, 1)
    assert tuple(create_mesh(data=4, model=2, device_type="cpu").shape) == (
        4, 2)
    with pytest.raises(ValueError, match="does not match"):
        create_mesh(data=3, model=2)  # 6 != 8
    with pytest.raises(ValueError, match="divisible"):
        create_mesh(model=3)
    with pytest.raises(ValueError, match="positive"):
        create_mesh(model=0)
    for data, model in ((3, 2), (-1, 3), (1, 0)):  # the same errors as JAX
        with pytest.raises(ValueError) as ours:
            create_mesh(data=data, model=model)
        with pytest.raises(ValueError) as theirs:
            jcreate_mesh(data=data, model=model)
        assert str(ours.value) == str(theirs.value)


def test_mesh_asks_for_the_card(fake_world, monkeypatch):
    """Without ``device_type`` the mesh is on the card and raises on a host
    without one, as every entry point of the port does; there is no silent
    CPU mesh. (JAX's ``create_mesh`` takes ``jax.devices()``, whatever the
    default backend is.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake_world()
    config = types.SimpleNamespace(mesh_data=8, mesh_model=1)
    for build in (create_mesh, lambda: mesh_from_config(config)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert create_mesh(device_type="cpu").device_type == "cpu"
    with pytest.raises(ValueError, match="does not match"):  # still first
        create_mesh(data=3, model=2)


def test_mesh_coordinates_follow_the_rank(fake_world):
    fake_world(rank=5)
    mesh = create_mesh(data=2, model=4, device_type="cpu")
    assert mesh.get_local_rank("data") == 1
    assert mesh.get_local_rank("model") == 1


def _flax_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flax_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.mark.parametrize("family", ["conv128", "mixer2k"])
def test_every_leaf_is_placed_as_jax_places_it(family, fake_world):
    if family == "conv128":
        jmodel, model = JConvFlow(**CONV128), ConditionalConvFlow(**CONV128)
        dim = CONV128["noise_dimension"]
    else:
        jmodel, model = JMixer(**MIXER2K), ConditionalMLPMixerFlow(**MIXER2K)
        dim = MIXER2K["noise_dimension"]
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.ones((8, dim)),
                            jnp.zeros((8, 2)), method="init_all"))["params"]
    jleaves = dict(_flax_leaves(jax.tree_util.tree_map(
        lambda s: s.shape, shapes, is_leaf=lambda s: hasattr(s, "shape"))))
    fake_world()
    mesh = create_mesh(data=4, model=2, device_type="cpu")
    state = TrainState(model, make_optimizer(config_from_dict(_tp_config())),
                       0.9, device="cpu")
    placed = state_shardings(state, mesh)
    has_lift = any(n.startswith("encoder.lift.") for n in state.names)
    root = weights._root(model.architecture)
    split = 0
    assert len(state.names) == len(jleaves)
    for name, p in zip(state.names, state.params):
        path, _ = weights._flax_path(name, root, has_lift)
        jshape = jleaves[tuple(path)]
        flax_shape, sources = flax_layout(name, tuple(p.shape),
                                          model.architecture, has_lift)
        assert flax_shape == tuple(jshape), name
        want = tuple(jparam_partition_spec((), np.empty(jshape, np.int8), 2))
        assert param_partition_spec((), jshape, 2) == want, name
        expected = ((Replicate(), Shard(sources[want.index("model")]))
                    if "model" in want else (Replicate(), Replicate()))
        for slot in ("params", "mu", "nu", "ema"):
            assert placed[slot][name] == expected, (slot, name)
        split += "model" in want
    assert split, "no leaf is split over the model axis"
    if family == "conv128":  # JAX's test: a conv and a row-split projection
        specs = {tuple(jparam_partition_spec((), np.empty(s, np.int8), 2))
                 for s in jleaves.values()}
        assert (None, None, None, "model") in specs
        assert ("model", None) in specs


def test_pure_data_parallel_replicates_every_leaf(fake_world):
    fake_world()
    mesh = create_mesh(data=8, device_type="cpu")
    state = TrainState(ConditionalConvFlow(**CONV128),
                       make_optimizer(config_from_dict(_tp_config())), 0.9,
                       device="cpu")
    placed = state_shardings(state, mesh)
    assert all(p == (Replicate(), Replicate())
               for p in placed["params"].values())
    assert shard_state(state, mesh).dtensors("ema") is not None


# ---------------------------------------------------------------------------
# sharded steps on 2 gloo ranks
# ---------------------------------------------------------------------------


def _dp_config() -> TrainFlowConfig:
    return TrainFlowConfig(
        base=BaseConfig(batch_size=BATCH, n_steps=10, base_lr=LR,
                        weight_decay=1e-2, seed=0, grad_clip_norm=1.0,
                        warmup_steps=1, lr_schedule="cosine",
                        lr_final_fraction=0.05),
        model=ModelConfig(noise_dimension=2 * WINDOW, condition_dimension=16,
                          latent_dimension=8, num_blocks=2,
                          architecture="convnet",
                          architecture_options=dict(
                              channels=16, spatial=4, lift_channels=8,
                              bottleneck_dim=32)),
        dataset=DatasetConfig(dataset="audio", tokenization_strategy="mdct",
                              tokenization_config={
                                  "frame_size": FRAME_SIZE,
                                  "window_size": WINDOW, "coeff_scale": 4.0,
                                  "gain_norm": 0.05}),
        method=MethodConfig(method="improved_mean_flow",
                            use_improved_mean_flow=True,
                            time_sampling_full_proportion=0.25),
        training=TrainingConfig(sample_every=1000, sample_seed=0,
                                sample_steps=1, workdir="unused",
                                ema_decay=0.9),
        tpu=TPUConfig(precision="float32", skip_nonfinite_updates=True),
    )


def _tp_config() -> dict:
    cfg = _dp_config().to_dict()
    cfg["model"].update(noise_dimension=CONV128["noise_dimension"],
                        condition_dimension=16, latent_dimension=16)
    cfg["model"]["architecture_options"] = {
        k: CONV128[k] for k in ("channels", "bottleneck_dim", "spatial",
                                "lift_channels")}
    cfg["base"].update(warmup_steps=0, lr_schedule="constant",
                       grad_clip_norm=None)
    return cfg


def _random_params(jmodel, seed, x, scale=0.2):
    """JAX's init, every leaf nudged by ``scale`` N(0, 1) (the zero-init
    leaves carry gradient); jitted, as eager init takes seconds a leaf."""
    @jax.jit
    def init():
        params = jmodel.init(jax.random.PRNGKey(seed), x,
                             jnp.zeros((x.shape[0], 2)),
                             method="init_all")["params"]
        leaves, tree = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
        return jax.tree_util.tree_unflatten(tree, [
            leaf + scale * jax.random.normal(k, leaf.shape, leaf.dtype)
            for leaf, k in zip(leaves, keys)])

    return jax.device_get(init())


def _jax_draws(objective, key, x):
    k_noise, k_tr = jax.random.split(key)
    noise = jax.random.normal(k_noise, x.shape, dtype=x.dtype)
    t, r = objective.time_sampling.sample_time_pair(k_tr, x.shape[0],
                                                    dtype=x.dtype)
    return tuple(torch.from_numpy(np.array(a)) for a in (noise, t, r))


def _jax_steps(jcfg, jmodel, params, batches, mesh, tokenizer):
    """JAX's sharded single steps and the draws each takes from its key."""
    state = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, tx=jax_make_optimizer(jcfg),
        ema_params=jax.tree_util.tree_map(jnp.array, params), ema_decay=0.9)
    objective = jobjectives.create_loss_strategy(jcfg)
    step = jax_make_train_step(objective, tokenizer=tokenizer, flatten=True,
                               donate=False, skip_nonfinite=True)
    state = jshard_state(state, mesh)
    metrics, draws = [], []
    for k, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + k)
        x = jnp.asarray(batch)
        x = tokenizer.tokenize(x) if tokenizer is not None else x
        draws.append(_jax_draws(objective, key, x))
        state, m = step(state, key, jax.device_put(jnp.asarray(batch),
                                                   jbatch(mesh)))
        metrics.append(m)
    stacked = tuple(torch.stack(d) for d in zip(*draws))
    return state, metrics, stacked


def _one_process(state, step, batches, draws):
    series = []
    for k, batch in enumerate(batches):
        state, m = step(state, torch.from_numpy(np.asarray(batch)),
                        noise=draws[0][k], t=draws[1][k], r=draws[2][k])
        series.append(m)
    return state, {name: torch.stack([torch.as_tensor(m[name])
                                      for m in series]) for name in series[0]}


def _dp_batches():
    rng = np.random.default_rng(7)
    t = np.arange(FRAME_SIZE) / 44100.0
    out = []
    for k in range(STEPS):
        tone = 0.3 * np.sin(2 * np.pi * (220.0 * (k + 1)) * t)[None, :, None]
        noise = 0.2 * rng.standard_normal((BATCH, FRAME_SIZE, 2))
        out.append((tone + noise).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """JAX's steps, the port's one-process steps and both ranks' sharded
    steps, for the data- and the tensor-parallel case."""
    root = tmp_path_factory.mktemp("parallel")
    out = {}
    # data parallel: JAX over 8 devices, the port over 2 ranks
    jcfg = _dp_config()
    jmodel = jax_create_flow_model(jcfg)
    params = _random_params(jmodel, 3, jnp.zeros((2, 2 * WINDOW)))
    batches = _dp_batches()
    jadapter = jax_adapter_from_config(jcfg, jax_create_tokenization_strategy(
        jcfg.tokenization_strategy, jcfg.tokenization_config))
    jstate, jmetrics, draws = _jax_steps(jcfg, jmodel, params, batches,
                                         jcreate_mesh(data=8), jadapter)
    cfg = config_from_dict(jcfg.to_dict())
    model = create_flow_model(cfg)
    weights.load_flax_params(model, params)
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    state, metrics = _one_process(
        TrainState(model, make_optimizer(cfg), 0.9, device="cpu"),
        make_train_step(create_loss_strategy(cfg), adapter,
                        skip_nonfinite=True), batches, draws)
    out["dp"] = dict(jax=(jstate, jmetrics), one=(state, metrics))
    inputs = {"dp": {"config": jcfg.to_dict(),
                     "params": weights.flax_to_torch(params),
                     "batches": torch.from_numpy(np.stack(batches)),
                     "noise": draws[0], "t": draws[1], "r": draws[2]}}

    # tensor parallel: JAX over mesh 4 x 2, the port over mesh 1 x 2
    tcfg = _tp_config()
    jtcfg = TrainFlowConfig.from_dict(tcfg)
    jmodel = JConvFlow(**CONV128_STEP)
    params = _random_params(jmodel, 5, jnp.zeros((BATCH, 64)), scale=0.05)
    tbatches = [np.asarray(jax.random.normal(jax.random.PRNGKey(6 + k),
                                             (BATCH, 64))) for k in range(STEPS)]
    jstate, jmetrics, draws = _jax_steps(jtcfg, jmodel, params, tbatches,
                                         jcreate_mesh(data=4, model=2), None)
    cfg = config_from_dict(tcfg)
    model = ConditionalConvFlow(**CONV128_STEP)
    weights.load_flax_params(model, params)
    state, metrics = _one_process(
        TrainState(model, make_optimizer(cfg), 0.9, device="cpu"),
        make_train_step(create_loss_strategy(cfg), None, skip_nonfinite=True),
        tbatches, draws)
    out["tp"] = dict(jax=(jstate, jmetrics), one=(state, metrics))
    inputs["tp"] = {"config": tcfg, "model": CONV128_STEP,
                    "params": weights.flax_to_torch(params),
                    "batches": torch.from_numpy(np.stack(tbatches)),
                    "noise": draws[0], "t": draws[1], "r": draws[2]}

    torch.save(inputs, root / "inputs.pt")
    torch_ranks.launch(torch_ranks.sharded_steps, 2, str(root / "inputs.pt"),
                       str(root / "rank{rank}.pt"))
    ranks = [torch.load(root / f"rank{r}.pt") for r in range(2)]
    for kind in ("dp", "tp"):
        out[kind]["ranks"] = [r[kind] for r in ranks]
    return out


def _rel_l2(got, want):
    got, want = (torch.cat([t.reshape(-1).double() for t in ts])
                 for ts in (got, want))
    return float((got - want).norm() / want.norm())


def _check(case, one_tol, params_rel, jax_atol):
    jstate, jmetrics = case["jax"]
    one, one_metrics = case["one"]
    for sharded in case["ranks"]:
        assert sharded["step"] == one.step == STEPS
        assert sharded["metrics"]["update_ok"].tolist() == [True] * STEPS
        for name in ("loss", "grad_norm", "mse"):
            np.testing.assert_allclose(
                sharded["metrics"][name].numpy(),
                np.asarray([float(m[name]) for m in jmetrics]), rtol=1e-4,
                err_msg=f"{name} against JAX")
            np.testing.assert_allclose(
                sharded["metrics"][name].numpy(), one_metrics[name].numpy(),
                **one_tol, err_msg=f"{name} against one process")
        names = list(sharded["params"])
        for slot in ("params", "mu", "nu", "ema"):
            got = (list(sharded["params"].values()) if slot == "params"
                   else sharded[slot])
            want = (list(dict(one.model.named_parameters()).values())
                    if slot == "params" else getattr(one, slot))
            assert _rel_l2(got, [w.detach() for w in want]) <= params_rel, slot
        for slot, tree in (("params", jstate.params),
                           ("ema", jstate.ema_params)):
            want = weights.flax_to_torch(jax.device_get(tree))
            got = (sharded["params"] if slot == "params"
                   else dict(zip(names, sharded["ema"])))
            assert _rel_l2([got[k] for k in want], list(want.values())) <= 1e-5
            for key, value in want.items():
                np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                           rtol=0, atol=jax_atol * LR,
                                           err_msg=f"{slot} {key} vs JAX")


def test_data_parallel_steps_match_jax_and_one_process(cases):
    _check(cases["dp"], dict(rtol=1e-5), params_rel=1e-5, jax_atol=1e-2)
    a, b = cases["dp"]["ranks"]
    for name in a["params"]:  # every rank holds the same replicated state
        assert torch.equal(a["params"][name], b["params"][name]), name


def test_tensor_parallel_steps_match_jax_and_the_replicated_step(cases):
    _check(cases["tp"], dict(rtol=1e-5), params_rel=1e-5, jax_atol=0.1)
    rank0, rank1 = cases["tp"]["ranks"]
    placements, shapes = rank0["placements"], rank0["local_shapes"]
    split = {n: dim for n, dim in placements.items() if dim is not None}
    assert split and len(split) < len(placements)
    one = dict(cases["tp"]["one"][0].model.named_parameters())
    for name, dim in split.items():  # each rank keeps half of a split leaf
        assert shapes[name][dim] * 2 == one[name].shape[dim], name
    assert rank1["local_shapes"] == shapes
