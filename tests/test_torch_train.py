"""PyTorch port: the iMF train step and its pieces against the JAX package.

Noise, t and r are drawn by JAX from the key its loss uses and passed to the
port, so both sides see the same draws. Parameters take Flax's init tree with
every leaf redrawn from a seeded numpy generator and go to the port through
``weights.flax_to_torch``.

Tolerances, each with its reason:
  * time sampling, schedules, losses, the learning-rate schedule: rtol 1e-6
    (the same f32 formulas; the port evaluates the schedule in float64);
  * AdamW + clip on a small tree: rtol 1e-5 / atol 1e-7 (one f32 update);
  * the iMF loss and mse: rtol 1e-4; every parameter gradient: rtol 1e-3 /
    atol 1e-5 of the largest gradient of its leaf (two forwards and a JVP in
    float32, summed in another order, then differentiated);
  * K = 3 train steps: loss and grad_norm rtol 1e-4; parameters and EMA
    within 1e-2 * lr of JAX's. Adam's first updates are about
    lr * g / (|g| + eps), so agreeing gradients give agreeing updates to a
    small fraction of lr, whatever the gradient's size.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meanflow_audio_codec_tpu.configs import (
    BaseConfig,
    DatasetConfig,
    MethodConfig,
    ModelConfig,
    TPUConfig,
    TrainFlowConfig,
    TrainingConfig,
    load_config_from_json,
)
from meanflow_audio_codec_tpu.models import conv_flow as jconv
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import (
    TrainState as JaxTrainState,
)
from meanflow_audio_codec_tpu.ops import losses as jlosses
from meanflow_audio_codec_tpu.ops import schedules as jschedules
from meanflow_audio_codec_tpu.ops import time_sampling as jtime
from meanflow_audio_codec_tpu.ops.tokenize import (
    create_tokenization_strategy as jax_create_tokenization_strategy,
)
from meanflow_audio_codec_tpu.training import objectives as jobjectives
from meanflow_audio_codec_tpu.training.train_step import (
    make_train_step as jax_make_train_step,
)
from meanflow_audio_codec_tpu.training.trainer import (
    adapter_from_config as jax_adapter_from_config,
)
from meanflow_audio_codec_tpu.training.trainer import (
    lr_at_step as jax_lr_at_step,
)
from meanflow_audio_codec_tpu.training.trainer import (
    make_lr_schedule as jax_make_lr_schedule,
)
from meanflow_audio_codec_tpu.training.trainer import (
    make_optimizer as jax_make_optimizer,
)
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict, load_config
from meanflow_audio_codec_torch.models import conv_flow
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops import losses, schedules, time_sampling
from meanflow_audio_codec_torch.ops.tokenize import (
    create_tokenization_strategy,
)
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.objectives import (
    ImprovedMeanFlowObjective,
    create_loss_strategy,
)
from meanflow_audio_codec_torch.training.optim import (
    AdamW,
    TrainState,
    global_norm,
    lr_at_step,
    make_lr_schedule,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

REPO = Path(__file__).resolve().parents[1]
EXACT = dict(rtol=1e-6, atol=1e-7)


def _np(t):
    return t.detach().float().numpy()


def _random_params(module, seed, *args, scale=0.3, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        shapes["params"])


# ---------------------------------------------------------------------------
# time sampling, schedules, losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,full", [(0.5, 0.0), (0.25, 0.25), (0.0, 1.0)])
def test_sample_tr_prefix_masks(data, full):
    gen = torch.Generator().manual_seed(0)
    t, r = time_sampling.sample_tr(16, gen, data_proportion=data,
                                   full_interval_proportion=full)
    n_data, n_full = int(16 * data), int(16 * full)
    assert t.shape == r.shape == (16, 1)
    assert torch.equal(r[:n_data], t[:n_data])
    assert (t[n_data:n_data + n_full] == 1).all()
    assert (r[n_data:n_data + n_full] == 0).all()
    rest = slice(n_data + n_full, None)
    assert (r[rest] < t[rest]).all() and ((t > 0) & (t <= 1)).all()


@pytest.mark.parametrize("sampler", [
    time_sampling.UniformTimeSampling(),
    time_sampling.LogitNormalTimeSampling(mean=0.3, std=0.5),
    time_sampling.MeanFlowTimeSampling()])
def test_time_samplers_draw_columns_in_the_unit_interval(sampler):
    t = sampler.sample_time(32, torch.Generator().manual_seed(1))
    assert t.shape == (32, 1) and t.dtype == torch.float32
    assert ((t >= 0) & (t <= 1)).all() and t.std() > 0


def test_sample_tr_matches_jax_on_the_same_normals(monkeypatch):
    """The same normal draws give JAX's (t, r): the port's draws are
    replaced by JAX's normals for t and r, in JAX's order."""
    key = jax.random.PRNGKey(3)
    k_t, k_r = jax.random.split(key, 2)
    normals = [np.array(jax.random.normal(k, (12, 1))) for k in (k_t, k_r)]
    t_ref, r_ref = jtime.sample_tr(key, 12, data_proportion=0.25,
                                   full_interval_proportion=0.25)

    draws = iter(normals)
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **k: torch.from_numpy(next(draws)))
    t, r = time_sampling.sample_tr(12, data_proportion=0.25,
                                   full_interval_proportion=0.25)
    np.testing.assert_allclose(_np(t), np.asarray(t_ref), **EXACT)
    np.testing.assert_allclose(_np(r), np.asarray(r_ref), **EXACT)


@pytest.mark.parametrize("name,kwargs", [("linear", {}),
                                         ("linear", {"noise_min": 0.01,
                                                     "noise_max": 0.9}),
                                         ("uniform", {}), (None, {})])
def test_noise_schedules_match_jax(name, kwargs):
    rng = np.random.default_rng(1)
    x0, x1 = rng.standard_normal((2, 5, 7)).astype(np.float32)
    t = rng.uniform(size=(5, 1)).astype(np.float32)
    ours = schedules.create_noise_schedule(name, **kwargs)
    ref = jschedules.create_noise_schedule(name, **kwargs)
    for fn, args in (("interpolate", (x0, x1, t)),
                     ("compute_target", (x0, x1))):
        got = getattr(ours, fn)(*map(torch.from_numpy, args))
        want = getattr(ref, fn)(*map(jnp.asarray, args))
        np.testing.assert_allclose(_np(got), np.asarray(want), **EXACT)
    with pytest.raises(ValueError):
        schedules.create_noise_schedule("cosine")


@pytest.mark.parametrize("weighting", ["uniform", "time_dependent", None])
def test_losses_match_jax(weighting):
    rng = np.random.default_rng(2)
    pred, target = rng.standard_normal((2, 6, 9)).astype(np.float32)
    pred[0] = target[0] + 1e-3  # a tiny error: the weight's c matters
    t = rng.uniform(size=(6, 1)).astype(np.float32)
    pt, tt, ttime = map(torch.from_numpy, (pred, target, t))
    pj, tj, tjime = map(jnp.asarray, (pred, target, t))
    for ours, ref in ((losses.weighted_l2_per_example,
                       jlosses.weighted_l2_per_example),
                      (losses.mse_per_example, jlosses.mse_per_example)):
        got = losses.apply_loss_weighting(ours(pt, tt), ttime, weighting)
        want = jlosses.apply_loss_weighting(ref(pj, tj), tjime, weighting, {})
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(_np(losses.mse_loss(pt, tt)),
                               np.asarray(jlosses.mse_loss(pj, tj)), rtol=1e-6)
    # the adaptive weight is a constant to the gradient
    p = pt.clone().requires_grad_()
    (grad,) = torch.autograd.grad(
        losses.weighted_l2_per_example(p, tt).sum(), [p])
    jgrad = jax.grad(lambda a: jlosses.weighted_l2_per_example(a, tj).sum())(pj)
    np.testing.assert_allclose(_np(grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


def test_learned_loss_weighting_is_not_ported():
    with pytest.raises(NotImplementedError):
        losses.apply_loss_weighting(torch.ones(2), torch.ones(2, 1), "learned")


# ---------------------------------------------------------------------------
# config, schedule, optimiser
# ---------------------------------------------------------------------------

TRAINING_FIELDS = (
    # base.*
    "batch_size", "n_steps", "base_lr", "weight_decay", "warmup_steps",
    "lr_schedule", "lr_final_fraction", "grad_clip_norm",
    # training.*
    "ema_decay",
    # method.*
    "method", "use_improved_mean_flow", "loss_strategy", "noise_schedule",
    "noise_min", "noise_max", "time_sampling", "time_sampling_mean",
    "time_sampling_std", "time_sampling_data_proportion", "flow_ratio",
    "time_sampling_full_proportion", "use_weighted_loss",
    "use_stop_gradient", "loss_weighting", "qat_mode", "qat_step_frac",
    "qat_bits",
    # tpu.*
    "skip_nonfinite_updates",
)


@pytest.mark.parametrize("name", ["frontier_v2.json",
                                  "ablations/ablation--no_stop_gradient.json"])
def test_config_reader_training_fields_match_jax(name):
    path = REPO / "configs" / name
    ours, ref = load_config(path), load_config_from_json(path)
    for field_name in TRAINING_FIELDS:  # the JAX config's flat access
        assert getattr(ours, field_name) == getattr(ref, field_name), field_name


def test_objective_from_frontier_v2_matches_jax():
    path = REPO / "configs" / "frontier_v2.json"
    ours = create_loss_strategy(load_config(path))
    ref = jobjectives.create_loss_strategy(load_config_from_json(path))
    assert isinstance(ref, jobjectives.ImprovedMeanFlowObjective)
    for name in ("use_weighted_loss", "use_stop_gradient", "loss_weighting"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert (vars(ours.noise_schedule) == vars(ref.noise_schedule))
    assert vars(ours.time_sampling) == vars(ref.time_sampling)


def test_unported_objectives_raise():
    base = {"noise_dimension": 8, "condition_dimension": 4,
            "latent_dimension": 2, "num_blocks": 1}
    for method in ({"method": "flow_matching"}, {"method": "mean_flow"},
                   {"method": "autoencoder"},
                   {"method": "improved_mean_flow", "qat_bits": 8},
                   {"method": "improved_mean_flow",
                    "use_stop_gradient": False}):
        with pytest.raises(NotImplementedError):
            create_loss_strategy(config_from_dict({"model": base,
                                                   "method": method}))


def _schedule_config(schedule, warmup, n_steps=20):
    base = BaseConfig(batch_size=2, n_steps=n_steps, base_lr=1e-3,
                      weight_decay=1e-2, seed=0, warmup_steps=warmup,
                      lr_schedule=schedule, lr_final_fraction=0.1,
                      grad_clip_norm=0.5)
    return TrainFlowConfig(
        base=base,
        model=ModelConfig(noise_dimension=8, condition_dimension=4,
                          latent_dimension=2, num_blocks=1),
        dataset=DatasetConfig(dataset="audio"),
        method=MethodConfig(),
        training=TrainingConfig(sample_every=1, sample_seed=0,
                                sample_steps=1, workdir="unused"),
    )


@pytest.mark.parametrize("schedule,warmup", [("constant", 0),
                                             ("constant", 4), ("cosine", 0),
                                             ("cosine", 5)])
def test_lr_schedule_matches_optax(schedule, warmup):
    jcfg = _schedule_config(schedule, warmup)
    cfg = config_from_dict(jcfg.to_dict())
    optax_schedule = jax_make_lr_schedule(jcfg)
    ours = make_lr_schedule(cfg)
    for step in range(25):
        want = (optax_schedule(step) if callable(optax_schedule)
                else optax_schedule)
        np.testing.assert_allclose(ours(step), float(want), rtol=1e-6,
                                   atol=1e-12)
        assert lr_at_step(cfg, step) == pytest.approx(
            jax_lr_at_step(jcfg, step), rel=1e-12)
    if warmup:
        assert ours(0) == 0.0  # the first update under warmup has lr 0


@pytest.mark.parametrize("clip_norm", [0.05, 100.0], ids=["clipped",
                                                          "not_clipped"])
def test_adamw_and_clip_match_optax(clip_norm):
    jcfg = _schedule_config("cosine", 2)
    jcfg.base.grad_clip_norm = clip_norm
    cfg = config_from_dict(jcfg.to_dict())
    tx = jax_make_optimizer(jcfg)
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(jparams)
    opt = make_optimizer(cfg)
    assert isinstance(opt, AdamW) and opt.grad_clip_norm == clip_norm
    params = [torch.from_numpy(tree[k].copy()) for k in ("w", "b")]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for count in range(5):
        g = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in tree.items()}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = [torch.from_numpy(g[k]) for k in ("w", "b")]
        norm = global_norm(grads)
        np.testing.assert_allclose(_np(norm), np.asarray(optax.global_norm(
            jax.tree_util.tree_map(jnp.asarray, g))), rtol=1e-6)
        params, mu, nu = opt.update(params, grads, mu, nu, count, norm)
        for p, k in zip(params, ("w", "b")):
            np.testing.assert_allclose(_np(p), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the iMF loss and its gradients
# ---------------------------------------------------------------------------

# the geometry of tests/test_stage_pallas.py::test_conv_flow_fused_imf_*
IMF_FLOW = dict(noise_dimension=64, condition_dimension=32, num_blocks=2,
                latent_dimension=16, channels=128, bottleneck_dim=32,
                spatial=4, lift_channels=8)


def _jax_draws(objective, key, x):
    """The noise, t and r that ``objective.loss`` draws from ``key``."""
    k_noise, k_tr = jax.random.split(key)
    noise = jax.random.normal(k_noise, x.shape, dtype=x.dtype)
    t, r = objective.time_sampling.sample_time_pair(k_tr, x.shape[0],
                                                    dtype=x.dtype)
    return tuple(torch.from_numpy(np.array(a)) for a in (noise, t, r))


def _grad_close(got: torch.Tensor, want: np.ndarray, name: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_imf_loss_and_gradients_match_jax(fused):
    x = (0.3 * np.random.default_rng(1).standard_normal((8, 64))).astype(
        np.float32)
    jmodel = jconv.ConditionalConvFlow(**IMF_FLOW, fused_stage=fused)
    params = _random_params(jmodel, 0, jnp.asarray(x), jnp.zeros((8, 2)),
                            method="init_all", scale=0.1)
    jobj = jobjectives.ImprovedMeanFlowObjective(
        time_sampling=jtime.MeanFlowTimeSampling(full_interval_proportion=0.25))
    key = jax.random.PRNGKey(5)

    def wrapped(p):
        return jobj.loss(p, jmodel.apply, key, jnp.asarray(x))

    (loss_ref, aux_ref), grads_ref = jax.jit(
        jax.value_and_grad(wrapped, has_aux=True))(params)

    model = conv_flow.ConditionalConvFlow(**IMF_FLOW, fused_stage=fused)
    weights.load_flax_params(model, params)
    noise, t, r = _jax_draws(jobj, key, jnp.asarray(x))
    assert (r[:4] == t[:4]).all() and (t[4:6] == 1).all()
    obj = ImprovedMeanFlowObjective(
        time_sampling=time_sampling.MeanFlowTimeSampling(
            full_interval_proportion=0.25))
    loss, aux = obj.loss(model, torch.from_numpy(x), noise=noise, t=t, r=r)
    np.testing.assert_allclose(_np(loss), np.asarray(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(_np(aux["mse"]), np.asarray(aux_ref["mse"]),
                               rtol=1e-4)
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    want = weights.flax_to_torch(grads_ref)
    assert set(grads) == set(want)
    for name, g in grads.items():
        _grad_close(g, want[name].numpy(), name)


def test_imf_loss_draws_from_a_generator():
    model = conv_flow.ConditionalConvFlow(**IMF_FLOW)
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    obj = ImprovedMeanFlowObjective()
    a = obj.loss(model, x, generator=torch.Generator().manual_seed(1))[0]
    b = obj.loss(model, x, generator=torch.Generator().manual_seed(1))[0]
    c = obj.loss(model, x, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        obj.loss(model, x, t=torch.ones(8, 1))


# ---------------------------------------------------------------------------
# K train steps
# ---------------------------------------------------------------------------

WINDOW, FRAME_SIZE, STEPS = 64, 1024, 3
ARCH = dict(channels=16, spatial=4, lift_channels=8, bottleneck_dim=32)


def _train_config(fused: bool) -> TrainFlowConfig:
    return TrainFlowConfig(
        base=BaseConfig(batch_size=2, n_steps=10, base_lr=1e-3,
                        weight_decay=1e-2, seed=0, grad_clip_norm=1.0,
                        warmup_steps=1, lr_schedule="cosine",
                        lr_final_fraction=0.05),
        model=ModelConfig(noise_dimension=2 * WINDOW, condition_dimension=16,
                          latent_dimension=8, num_blocks=2,
                          architecture="convnet",
                          architecture_options=dict(ARCH, fused_stage=fused)),
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


def _batches():
    rng = np.random.default_rng(7)
    t = np.arange(FRAME_SIZE) / 44100.0
    out = []
    for k in range(STEPS):
        tone = 0.3 * np.sin(2 * np.pi * (220.0 * (k + 1)) * t)[None, :, None]
        noise = 0.2 * rng.standard_normal((2, FRAME_SIZE, 2))
        out.append((tone + noise).astype(np.float32))
    return out


def _jax_run(jcfg, params, batches):
    model = jax_create_flow_model(jcfg)
    state = JaxTrainState.create(
        apply_fn=model.apply, params=params, tx=jax_make_optimizer(jcfg),
        ema_params=jax.tree_util.tree_map(jnp.array, params),
        ema_decay=jcfg.training.ema_decay)
    objective = jobjectives.create_loss_strategy(jcfg)
    adapter = jax_adapter_from_config(jcfg, jax_create_tokenization_strategy(
        jcfg.tokenization_strategy, jcfg.tokenization_config))
    step = jax_make_train_step(objective, tokenizer=adapter, flatten=True,
                               donate=False, skip_nonfinite=True)
    metrics, draws = [], []
    for k, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + k)
        x = adapter.tokenize(jnp.asarray(batch))
        draws.append(_jax_draws(objective, key, x))
        state, m = step(state, key, jnp.asarray(batch))
        metrics.append(m)
    return state, metrics, draws


def _port_state(jcfg, params):
    cfg = config_from_dict(jcfg.to_dict())
    model = create_flow_model(cfg)
    weights.load_flax_params(model, params)
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    state = TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                       device="cpu")
    step = make_train_step(create_loss_strategy(cfg), adapter,
                           skip_nonfinite=cfg.skip_nonfinite_updates)
    return state, step


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_steps_match_jax(fused):
    jcfg = _train_config(fused)
    jmodel = jax_create_flow_model(jcfg)
    params = _random_params(jmodel, 3, jnp.zeros((2, 2 * WINDOW)),
                            jnp.zeros((2, 2)), method="init_all", scale=0.2)
    batches = _batches()
    jstate, jmetrics, draws = _jax_run(jcfg, params, batches)

    state, step = _port_state(jcfg, params)
    for batch, (noise, t, r), jm in zip(batches, draws, jmetrics):
        state, m = step(state, torch.from_numpy(batch), noise=noise, t=t, r=r)
        assert m["update_ok"] and bool(jm["update_ok"])
        np.testing.assert_allclose(_np(m["loss"]), np.asarray(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(_np(m["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == STEPS
    lr = jcfg.base.base_lr
    for name, tree in (("params", jstate.params), ("ema", jstate.ema_params)):
        want = weights.flax_to_torch(tree)
        got = (dict(state.model.named_parameters()) if name == "params"
               else state.ema_state_dict())
        for key, value in want.items():
            np.testing.assert_allclose(_np(got[key]), value.numpy(), rtol=0,
                                       atol=1e-2 * lr, err_msg=f"{name} {key}")


def test_nonfinite_batch_keeps_the_whole_state():
    jcfg = _train_config(True)
    jmodel = jax_create_flow_model(jcfg)
    params = _random_params(jmodel, 3, jnp.zeros((2, 2 * WINDOW)),
                            jnp.zeros((2, 2)), method="init_all", scale=0.2)
    batches = _batches()
    batches[1] = batches[1].copy()
    batches[1][0, 100, 0] = np.nan
    jstate, jmetrics, draws = _jax_run(jcfg, params, batches)
    assert [bool(m["update_ok"]) for m in jmetrics] == [True, False, True]

    state, step = _port_state(jcfg, params)
    state, _ = step(state, torch.from_numpy(batches[0]), noise=draws[0][0],
                    t=draws[0][1], r=draws[0][2])
    before = {k: [t.clone() for t in getattr(state, k)]
              for k in ("params", "mu", "nu", "ema")}
    state, m = step(state, torch.from_numpy(batches[1]), noise=draws[1][0],
                    t=draws[1][1], r=draws[1][2])
    assert m["update_ok"] is False and state.step == 1
    for k, tensors in before.items():
        for a, b in zip(tensors, getattr(state, k)):
            assert torch.equal(a, b), k
    state, m = step(state, torch.from_numpy(batches[2]), noise=draws[2][0],
                    t=draws[2][1], r=draws[2][2])
    assert m["update_ok"] and state.step == int(jstate.step) == 2
    want = weights.flax_to_torch(jstate.params)
    for key, value in state.model.named_parameters():
        np.testing.assert_allclose(_np(value), want[key].numpy(), rtol=0,
                                   atol=1e-2 * jcfg.base.base_lr, err_msg=key)


def test_train_state_asks_for_the_card_by_default(monkeypatch):
    cfg = config_from_dict(_train_config(True).to_dict())
    model = create_flow_model(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TrainState(model, make_optimizer(cfg), cfg.ema_decay)
    with pytest.raises(RuntimeError, match="cuda"):
        TrainState(model, make_optimizer(cfg), cfg.ema_decay, device="cuda")


@pytest.mark.parametrize("label", ["batch", "noise", "t", "r"])
def test_train_step_rejects_tensors_off_the_state_device(label):
    cfg = config_from_dict(_train_config(True).to_dict())
    state = TrainState(create_flow_model(cfg), make_optimizer(cfg),
                       cfg.ema_decay, device="cpu")
    adapter = adapter_from_config(cfg, create_tokenization_strategy(
        cfg.tokenization_strategy, cfg.tokenization_config))
    step = make_train_step(create_loss_strategy(cfg), adapter)
    before = [p.clone() for p in state.params]
    args = {"batch": torch.from_numpy(_batches()[0])}
    args[label] = torch.empty_like(args.get(label, torch.zeros(2)),
                                   device="meta")
    with pytest.raises(ValueError, match=f"{label} is on meta"):
        step(state, args.pop("batch"), **args)
    assert state.step == 0
    assert all(torch.equal(a, b) for a, b in zip(before, state.params))
