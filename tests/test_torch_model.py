"""PyTorch port: embeddings, blocks, the ConvNeXt flow, the weight converter,
the config reader and the factory, against the JAX package.

Parameters take the tree of Flax ``init`` and are redrawn from a seeded numpy
generator (so layer-scale, GRN and biases are not at their near-identity
init values and every path contributes), converted with
``weights.flax_to_torch``. Inputs are numpy arrays handed to both sides.

Tolerances: float32 on both sides at rtol 1e-4 / atol 1e-5 — the same f32
arithmetic, differing only in summation order between XLA and PyTorch's CPU
kernels. One bfloat16 case at relative L2 <= 2e-2 — both sides round every
layer's inputs, weights and outputs to bf16 (8 mantissa bits, ~4e-3 per
rounding), but at different points inside fused ops, and the differences
add up over the stages.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.configs import load_config_from_json
from meanflow_audio_codec_tpu.models import blocks as jblocks
from meanflow_audio_codec_tpu.models import conv_flow as jconv
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.ops.embeddings import (
    dual_time_embedding as jax_dual_time_embedding,
)
from meanflow_audio_codec_tpu.ops.sampling import (
    sample_dual_time as jax_sample_dual_time,
)
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.configs import config_from_dict, load_config
from meanflow_audio_codec_torch.models import blocks, conv_flow
from meanflow_audio_codec_torch.models.factories import (
    compute_dtype_for,
    create_flow_model,
)
from meanflow_audio_codec_torch.ops.embeddings import dual_time_embedding
from meanflow_audio_codec_torch.ops.sampling import sample_dual_time

RTOL, ATOL = 1e-4, 1e-5
REPO = Path(__file__).resolve().parents[1]

# small geometry: W=64 stereo -> 128-wide rows (non-square: encoder lifts)
NOISE, COND, LATENT = 128, 16, 8
SMALL = dict(channels=16, spatial=4, lift_channels=8, bottleneck_dim=32)


def init_random(module, seed, *args, **kwargs):
    """Flax init's param tree, every leaf redrawn from a seeded normal."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return randomize(shapes["params"], seed)


def randomize(params, seed, scale=0.3):
    """Same tree, every leaf redrawn from a seeded normal."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def to_np(t):
    return t.detach().float().numpy()


def test_dual_time_embedding_matches_jax():
    time = np.random.default_rng(0).uniform(0, 1, (5, 2)).astype(np.float32)
    got = dual_time_embedding(torch.from_numpy(time), 32)
    ref = jax_dual_time_embedding(jnp.asarray(time), 32)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_adaln_norm_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 4, 4, 24)).astype(
        np.float32) * 3 + 1
    got = blocks.adaln_norm(torch.from_numpy(x))
    ref = jblocks._adaln_norm(jnp.asarray(x))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_grn_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 32)).astype(
        np.float32)
    x[:, :, :, 5] = 0.0  # a dead channel: the eps inside the sqrt
    module = jblocks.GlobalResponseNormalization()
    params = init_random(module, 3, jnp.asarray(x))
    ref = jax.jit(module.apply)({"params": params}, jnp.asarray(x))
    grn = blocks.GlobalResponseNormalization(32)
    grn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(to_np(grn(torch.from_numpy(x))),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_convnext_block_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 4, 4, 16)).astype(
        np.float32)
    module = jblocks.ConvNeXtBlock(dim=16)
    params = init_random(module, 5, jnp.asarray(x))
    ref = jax.jit(module.apply)({"params": params}, jnp.asarray(x))
    block = blocks.ConvNeXtBlock(16)
    sd = weights.flax_to_torch({"blocks_0": {"ConvNeXtBlock_0": params}})
    block.load_state_dict({k.removeprefix("stages.0.block."): v
                           for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(to_np(block(torch.from_numpy(x))),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lift_channels", [8, None])
def test_conv_stage_matches_jax(lift_channels):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, NOISE)).astype(np.float32)
    cond = rng.standard_normal((3, COND)).astype(np.float32)
    geometry = dict(SMALL, lift_channels=lift_channels)
    module = jconv.ConvStage(noise_dimension=NOISE, condition_dimension=COND,
                             num_blocks=2, **geometry)
    params = init_random(module, 7, jnp.asarray(x), jnp.asarray(cond))
    ref = jax.jit(module.apply)({"params": params}, jnp.asarray(x), jnp.asarray(cond))
    stage = conv_flow.ConvStage(NOISE, COND, 2, **geometry)
    sd = weights.flax_to_torch({"blocks_0": params})
    stage.load_state_dict({k.removeprefix("stages.0."): v
                           for k, v in sd.items()}, strict=True)
    got = stage(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("noise_dim", [128, 64, 49])
def test_conv_encoder_matches_jax(noise_dim):
    """128: lifted to a 12x12 grid; 64: square 8x8 (stride-2 SAME pads
    (0, 1)); 49: odd 7x7 grid (pads (1, 1))."""
    x = np.random.default_rng(8).standard_normal((3, noise_dim)).astype(
        np.float32)
    module = jconv.ConvEncoder(noise_dimension=noise_dim,
                               latent_dimension=LATENT)
    params = init_random(module, 9, jnp.asarray(x))
    ref = jax.jit(module.apply)({"params": params}, jnp.asarray(x))
    encoder = conv_flow.ConvEncoder(noise_dim, LATENT)
    sd = weights.flax_to_torch({"encoder": params})
    encoder.load_state_dict({k.removeprefix("encoder."): v
                             for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(to_np(encoder(torch.from_numpy(x))),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)


def _flow_pair(dtype_jax, dtype_torch, seed=10):
    jmodel = jconv.ConditionalConvFlow(
        noise_dimension=NOISE, condition_dimension=COND, num_blocks=2,
        latent_dimension=LATENT, dtype=dtype_jax, **SMALL)
    params = init_random(jmodel, seed, jnp.zeros((2, NOISE)),
                         jnp.zeros((2, 2)), method="init_all")
    tmodel = conv_flow.ConditionalConvFlow(NOISE, COND, 2, LATENT,
                                           compute_dtype=dtype_torch, **SMALL)
    weights.load_flax_params(tmodel, params)
    return jmodel, params, tmodel


def _flow_inputs(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, NOISE)).astype(np.float32)
    time = np.stack([np.ones(4), np.linspace(0, 1, 4)], -1).astype(np.float32)
    latents = rng.standard_normal((4, LATENT)).astype(np.float32)
    return x, time, latents


def test_conditional_conv_flow_matches_jax_f32():
    jmodel, params, tmodel = _flow_pair(jnp.float32, torch.float32)
    x, time, latents = _flow_inputs()
    for lat in (latents, None):
        ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                           jnp.asarray(time),
                           None if lat is None else jnp.asarray(lat))
        got = tmodel(torch.from_numpy(x), torch.from_numpy(time),
                     None if lat is None else torch.from_numpy(lat))
        np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    ref = jmodel.apply({"params": params}, jnp.asarray(x), method="encode")
    np.testing.assert_allclose(to_np(tmodel.encode(torch.from_numpy(x))),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_conditional_conv_flow_matches_jax_bf16():
    jmodel, params, tmodel = _flow_pair(jnp.bfloat16, torch.bfloat16)
    x, time, latents = _flow_inputs()
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(time),
                       jnp.asarray(latents))
    got = tmodel(torch.from_numpy(x), torch.from_numpy(time),
                 torch.from_numpy(latents))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _rel_l2(to_np(got), np.asarray(ref, np.float32)) <= 2e-2
    ref = jmodel.apply({"params": params}, jnp.asarray(x), method="encode")
    got = tmodel.encode(torch.from_numpy(x))
    assert _rel_l2(to_np(got), np.asarray(ref, np.float32)) <= 2e-2


def _leaf_count(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_flax_to_torch_consumes_every_leaf_once():
    _, params, tmodel = _flow_pair(jnp.float32, torch.float32)
    sd = weights.flax_to_torch(params)
    assert len(sd) == _leaf_count(params) == len(tmodel.state_dict())
    assert set(sd) == set(tmodel.state_dict())
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_flax


def test_flax_to_torch_fails_loudly():
    _, params, tmodel = _flow_pair(jnp.float32, torch.float32)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        weights.flax_to_torch(extra)
    missing = {k: v for k, v in params.items() if k != "latent_proj"}
    with pytest.raises(RuntimeError, match="latent_proj"):
        weights.load_flax_params(tmodel, missing)


def test_config_reader_matches_jax_on_frontier_v2():
    path = REPO / "configs" / "frontier_v2.json"
    ours, ref = load_config(path), load_config_from_json(path)
    for name in ("noise_dimension", "condition_dimension", "latent_dimension",
                 "num_blocks", "architecture", "architecture_options",
                 "dataset", "tokenization_strategy", "tokenization_config"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.precision == ref.tpu.precision == "bfloat16"
    assert compute_dtype_for(ours) == torch.bfloat16


def test_config_reader_rejects_bad_input():
    with pytest.raises(ValueError):
        config_from_dict({"batch_size": 2})
    base = {"noise_dimension": 8, "condition_dimension": 4,
            "latent_dimension": 2, "num_blocks": 1}
    with pytest.raises(ValueError):
        config_from_dict({"model": dict(base, condition_dimension=3)})
    with pytest.raises(ValueError):
        config_from_dict({"model": base, "tpu": {"precision": "fp8"}})
    assert config_from_dict({"model": base}).precision == "mixed"


def test_factory_matches_jax_param_shapes_at_frontier_width():
    """The frontier-v2 model (full width) maps leaf for leaf onto the port.
    Shapes only: jax.eval_shape skips the 33M-parameter init."""
    path = REPO / "configs" / "frontier_v2.json"
    jcfg = load_config_from_json(path)
    jmodel = jax_create_flow_model(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 1024)),
                            jnp.zeros((2, 2)), method="init_all"))["params"]
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    tmodel = create_flow_model(load_config(path))
    expected = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    mapped = {key: weights._convert(kind, leaf, value).shape
              for key, kind, leaf, value in weights._walk(views, "flow", (),
                                                          "")}
    assert mapped == expected
    assert tmodel.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())


def test_factory_rejects_unported_families_and_options():
    base = {"noise_dimension": 128, "condition_dimension": 16,
            "latent_dimension": 8, "num_blocks": 1}
    with pytest.raises(NotImplementedError):
        create_flow_model(config_from_dict({"model": dict(base,
                                                          architecture="mlp")}))
    with pytest.raises(NotImplementedError):
        create_flow_model(config_from_dict({"model": dict(
            base, architecture="convnet",
            architecture_options={"quantized": True})}))
    # fused_stage is ported: it builds, with the plain model's parameters
    fused = create_flow_model(config_from_dict({"model": dict(
        base, architecture="convnet",
        architecture_options=dict(SMALL, fused_stage=True))}))
    plain = create_flow_model(config_from_dict({"model": dict(
        base, architecture="convnet", architecture_options=SMALL)}))
    assert fused.stages[0].fused_stage and not plain.stages[0].fused_stage
    assert ({k: v.shape for k, v in fused.state_dict().items()}
            == {k: v.shape for k, v in plain.state_dict().items()})


def test_seeded_init_is_reproducible():
    cfg = config_from_dict({"model": {
        "noise_dimension": 128, "condition_dimension": 16,
        "latent_dimension": 8, "num_blocks": 1, "architecture": "convnet",
        "architecture_options": SMALL}})
    a = create_flow_model(cfg, generator=torch.Generator().manual_seed(3))
    b = create_flow_model(cfg, generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    assert a.stages[0].block.layer_scale[0].item() == pytest.approx(1e-6)


@pytest.mark.parametrize("n_steps,heun,guidance", [(1, False, 1.0),
                                                   (2, False, 1.0),
                                                   (2, True, 1.0),
                                                   (1, False, 2.0)])
def test_sample_dual_time_matches_jax(n_steps, heun, guidance):
    jmodel, params, tmodel = _flow_pair(jnp.float32, torch.float32)
    x, _, latents = _flow_inputs(seed=12)
    ref = jax_sample_dual_time(jmodel.apply, NOISE, params,
                               jax.random.PRNGKey(0), jnp.asarray(latents),
                               n_steps=n_steps, guidance_scale=guidance,
                               heun=heun, noise=jnp.asarray(x))
    got = sample_dual_time(tmodel, NOISE, torch.from_numpy(latents),
                           n_steps=n_steps, guidance_scale=guidance,
                           heun=heun, noise=torch.from_numpy(x))
    assert got.dtype == torch.float32
    # atol 1e-4: the state sums up to four model outputs of magnitude ~10
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=RTOL,
                               atol=1e-4)
