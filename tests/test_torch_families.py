"""PyTorch port: the MLP, MLP-Mixer and simple-conv families against the
JAX package — each block and model forward and ``encode``, with the Flax
params converted by ``weights.flax_to_torch``; each family's msgpack
checkpoint both ways and its parameter count.

Parameters take the tree of Flax ``init`` and are redrawn from a seeded
numpy generator (so biases and the query tokens are away from their init
values and every path contributes). Inputs are numpy arrays handed to both
sides.

Tolerances: float32 on both sides at rtol 1e-5 / atol 1e-6 for a block
(one or two layers: the same f32 arithmetic, summed in another order), and
rtol 1e-5 with an atol of 1e-6 of the output's largest magnitude for a
whole model (the random weights drive its outputs to ~100, and an element
that cancels to near zero keeps the absolute error of its terms: read
4.0e-5 absolute at an output of 81, 5e-7 of it). bfloat16: relative L2 <= 2e-2 — both sides round
every layer's inputs, weights and outputs to bf16 (8 mantissa bits, ~4e-3
per rounding), XLA inside fused ops and PyTorch op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.models import blocks as jblocks
from meanflow_audio_codec_tpu.models import mlp_flow as jmlp
from meanflow_audio_codec_tpu.models import mlp_mixer as jmixer
from meanflow_audio_codec_tpu.models import simple_conv_flow as jsconv
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.training.checkpoints import (
    count_params as jax_count_params,
)
from meanflow_audio_codec_torch import serialization, weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models import blocks, mlp_flow, mlp_mixer
from meanflow_audio_codec_torch.models import simple_conv_flow as sconv
from meanflow_audio_codec_torch.models.factories import create_flow_model

BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_RTOL, MODEL_ATOL_OF_MAX = 1e-5, 1e-6
BF16_REL_L2 = 2e-2
COND = 16


def randomize(params, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def init_random(module, seed, *args, method=None):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, method=method))
    return randomize(shapes["params"], seed)


def rng_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def times(seed, batch):
    t = np.random.default_rng(seed).uniform(0, 1, (batch, 2))
    return t.astype(np.float32)


def assert_model_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        to_np(got), ref, rtol=MODEL_RTOL,
        atol=MODEL_ATOL_OF_MAX * float(np.abs(ref).max()))


def to_np(t):
    return t.detach().float().numpy()


def t_(a):
    return torch.from_numpy(np.asarray(a))


def load(model, params):
    return weights.load_flax_params(model, params)


def sub_state(params, wrap, prefix, architecture):
    """State dict of a sub-module whose Flax tree sits at ``wrap`` in an
    ``architecture`` model's."""
    state = weights.flax_to_torch(wrap(params), architecture)
    return {k.removeprefix(prefix): v for k, v in state.items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_mlp_block_matches_jax():
    (x,) = rng_inputs(0, (4, 24))
    module = jblocks.MLP(hidden=20, out=12)
    params = init_random(module, 1, jnp.asarray(x))
    ref = module.apply({"params": params}, jnp.asarray(x))
    got = blocks.MLP(24, 20, 12)
    got.load_state_dict(sub_state(params, lambda p: {"encoder": {"MLP_0": p}},
                                  "encoder.mlp.", "mlp"))
    np.testing.assert_allclose(to_np(got(t_(x))), np.asarray(ref),
                               **BLOCK_TOL)


def test_conditional_residual_block_matches_jax():
    x, c = rng_inputs(2, (4, 40), (4, COND))
    module = jblocks.ConditionalResidualBlock(
        input_dimension=40, noise_dimension=32, condition_dimension=COND,
        num_blocks=3)
    params = init_random(module, 3, jnp.asarray(x), jnp.asarray(c))
    ref = module.apply({"params": params}, jnp.asarray(x), jnp.asarray(c))
    got = blocks.ConditionalResidualBlock(40, 32, COND, 3)
    got.load_state_dict(sub_state(params, lambda p: {"blocks_0": p},
                                  "blocks.0.", "mlp"))
    np.testing.assert_allclose(to_np(got(t_(x), t_(c))), np.asarray(ref),
                               **BLOCK_TOL)


def test_mixer_block_matches_jax():
    x, c = rng_inputs(4, (3, 9, 6), (3, COND))
    module = jblocks.MixerBlock(token_mix_dim=20, channel_mix_dim=14,
                                num_channels=6, num_tokens=9,
                                condition_dim=COND)
    params = init_random(module, 5, jnp.asarray(x), jnp.asarray(c))
    ref = module.apply({"params": params}, jnp.asarray(x), jnp.asarray(c))
    got = blocks.MixerBlock(20, 14, 6, 9, COND)
    got.load_state_dict(sub_state(
        params, lambda p: {"stages_0": {"MixerBlock_0": p}},
        "stages.0.block.", "mlp_mixer"))
    np.testing.assert_allclose(to_np(got(t_(x), t_(c))), np.asarray(ref),
                               **BLOCK_TOL)


@pytest.mark.parametrize("in_channels,channels", [(4, 4), (3, 8)],
                         ids=["same", "residual_proj"])
def test_simple_conv_block_matches_jax(in_channels, channels):
    x, c = rng_inputs(6, (2, 6, 6, in_channels), (2, COND))
    module = jsconv.SimpleConvBlock(channels=channels)
    params = init_random(module, 7, jnp.asarray(x), jnp.asarray(c))
    ref = module.apply({"params": params}, jnp.asarray(x), jnp.asarray(c))
    got = sconv.SimpleConvBlock(in_channels, channels, COND)
    got.load_state_dict(sub_state(params, lambda p: {"down1": p}, "down1.",
                                  "simple_conv"))
    np.testing.assert_allclose(to_np(got(t_(x), t_(c))), np.asarray(ref),
                               **BLOCK_TOL)


@pytest.mark.parametrize("size_in,size_out", [(2, 5), (3, 6), (5, 10),
                                              (7, 15), (1, 3), (4, 4)])
def test_nearest_resize_picks_jax_pixels(size_in, size_out):
    (x,) = rng_inputs(8, (2, size_in, size_in + 1, 3))
    ref = jax.image.resize(jnp.asarray(x), (2, size_out, size_out + 2, 3),
                           method="nearest")
    got = sconv.resize_nearest(t_(x), size_out, size_out + 2)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

NOISE, LATENT, BLOCKS = 36, 6, 2
MIXER = dict(token_mix_dim=24, channel_mix_dim=20, num_channels=5,
             num_latent_tokens=3, encoder_context_tokens=4)


def _jax_model(family, noise, dtype=jnp.float32, **options):
    kwargs = dict(noise_dimension=noise, condition_dimension=COND,
                  num_blocks=BLOCKS, latent_dimension=LATENT, dtype=dtype)
    if family == "mlp":
        return jmlp.ConditionalFlow(**kwargs)
    if family == "mlp_mixer":
        return jmixer.ConditionalMLPMixerFlow(**kwargs, **options)
    return jsconv.SimpleConvFlow(**kwargs, **options)


def _torch_model(family, noise, dtype=torch.float32, **options):
    args = (noise, COND, BLOCKS, LATENT)
    if family == "mlp":
        return mlp_flow.ConditionalFlow(*args, compute_dtype=dtype)
    if family == "mlp_mixer":
        return mlp_mixer.ConditionalMLPMixerFlow(*args, compute_dtype=dtype,
                                                 **options)
    return sconv.SimpleConvFlow(*args, compute_dtype=dtype, **options)


CASES = {
    "mlp": ("mlp", NOISE, {}),
    # the reference lift at a width that is not a square: isqrt(40)**2 = 36
    # tokens
    "mixer_reference_lift": ("mlp_mixer", 40, MIXER),
    "mixer_factorized": ("mlp_mixer", 40, dict(MIXER, stage_tokens=8,
                                               factorized_stages=True)),
    # 100 -> 10 x 10 -> 5 x 5 -> 2 x 2: an odd pool, odd resizes
    "simple_conv_square": ("simple_conv", 100, dict(base_channels=4)),
    # 120 lifts onto the next even square, 12 x 12 -> 6 x 6 -> 3 x 3
    "simple_conv_lifted": ("simple_conv", 120, dict(base_channels=4)),
}


def _pair(case, dtype=jnp.float32, tdtype=torch.float32):
    family, noise, options = CASES[case]
    jmodel = _jax_model(family, noise, dtype, **options)
    (x,) = rng_inputs(10, (5, noise))
    params = init_random(jmodel, 11, jnp.asarray(x),
                         jnp.asarray(times(12, 5)), method="init_all")
    tmodel = load(_torch_model(family, noise, tdtype, **options), params)
    return jmodel, tmodel, params, x


@pytest.mark.parametrize("case", list(CASES))
def test_model_forward_and_encode_match_jax(case):
    jmodel, tmodel, params, x = _pair(case)
    time = times(13, x.shape[0])
    v = {"params": params}
    apply = jax.jit(jmodel.apply, static_argnames="method")
    lat = apply(v, jnp.asarray(x), method="encode")
    got_lat = tmodel.encode(t_(x))
    assert_model_close(got_lat, lat)
    assert tuple(got_lat.shape[1:]) == tmodel.latent_shape
    (given,) = rng_inputs(14, lat.shape)
    ref = apply(v, jnp.asarray(x), jnp.asarray(time), jnp.asarray(given))
    got = tmodel(t_(x), t_(time), t_(given))
    assert_model_close(got, ref)
    # latents=None: the zero-latent (CFG) path
    ref0 = apply(v, jnp.asarray(x), jnp.asarray(time))
    got0 = tmodel(t_(x), t_(time))
    assert_model_close(got0, ref0)
    zeros = torch.zeros((x.shape[0],) + tmodel.latent_shape)
    torch.testing.assert_close(tmodel(t_(x), t_(time), zeros), got0)


@pytest.mark.parametrize("case", ["mlp", "mixer_factorized",
                                  "simple_conv_lifted"])
def test_model_matches_jax_in_bfloat16(case):
    jmodel, tmodel, params, x = _pair(case, jnp.bfloat16, torch.bfloat16)
    time = times(15, x.shape[0])
    v = {"params": params}
    ref = np.asarray(jax.jit(lambda v, x, time: jmodel.apply(
        v, x, time, jmodel.apply(v, x, method="encode")))(
            v, jnp.asarray(x), jnp.asarray(time)), dtype=np.float32)
    got = tmodel(t_(x), t_(time), tmodel.encode(t_(x)))
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(to_np(got) - ref) / np.linalg.norm(ref)
    assert rel <= BF16_REL_L2, rel


def test_mixer_encoder_decoder_autoencoder_match_jax():
    (x,) = rng_inputs(16, (3, 20))
    kw = dict(num_latent_tokens=3, latent_dim=6, token_mix_dim=12,
              channel_mix_dim=10)
    jae = jmixer.MLPMixerAutoencoder(input_dim=20, num_context_tokens=5,
                                     num_output_tokens=4, **kw)
    params = init_random(jae, 17, jnp.asarray(x))
    ae = load(mlp_mixer.MLPMixerAutoencoder(20, num_context_tokens=5,
                                            num_output_tokens=4, **kw), params)
    v = {"params": params}
    lat = jae.apply(v, jnp.asarray(x), method="encode")
    assert_model_close(ae.encode(t_(x)), lat)
    (tokens,) = rng_inputs(18, lat.shape)
    assert_model_close(ae.decode(t_(tokens)),
                       jae.apply(v, jnp.asarray(tokens), method="decode"))
    assert_model_close(ae(t_(x)), jae.apply(v, jnp.asarray(x)))
    # the port's tree back to Flax's, leaf for leaf
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           weights.torch_to_flax(ae.state_dict(),
                                                 ae.architecture), params)
    # the encoder and decoder alone
    enc = mlp_mixer.MLPMixerEncoder(20, num_context_tokens=5, **kw)
    enc.load_state_dict({k.removeprefix("encoder."): val for k, val in
                         weights.flax_to_torch(params,
                                               ae.architecture).items()
                         if k.startswith("encoder.")})
    assert_model_close(enc(t_(x)), lat)


# ---------------------------------------------------------------------------
# the factory, checkpoints and parameter counts
# ---------------------------------------------------------------------------

FACTORY = {
    "mlp": {},
    "mlp_mixer": dict(MIXER),
    "mlp_mixer_factorized": dict(MIXER, stage_tokens=8,
                                 factorized_stages=True),
    "simple_conv": {},
}


def _configs(name, noise=40):
    architecture = name.removesuffix("_factorized")
    model = {"noise_dimension": noise, "condition_dimension": COND,
             "latent_dimension": LATENT, "num_blocks": BLOCKS,
             "architecture": architecture,
             "architecture_options": FACTORY[name]}
    data = {"model": model, "tpu": {"precision": "float32"},
            "base": {"batch_size": 2, "n_steps": 1, "base_lr": 1e-3,
                     "weight_decay": 0.0, "seed": 0},
            "training": {"workdir": "unused", "sample_every": 1,
                         "sample_seed": 0, "sample_steps": 1}}
    jcfg = TrainFlowConfig.from_dict(data)
    tcfg = config_from_dict(data)
    return jcfg, tcfg


@pytest.mark.parametrize("name", list(FACTORY))
def test_factory_checkpoint_both_ways_and_param_count(name, tmp_path):
    jcfg, tcfg = _configs(name)
    jmodel = jax_create_flow_model(jcfg)
    params = init_random(jmodel, 21, jnp.zeros((2, 40)), jnp.zeros((2, 2)),
                         method="init_all")
    tmodel = create_flow_model(tcfg,
                               generator=torch.Generator().manual_seed(0))
    assert (sum(p.numel() for p in tmodel.parameters())
            == jax_count_params(params))
    # JAX -> port: the msgpack the JAX package writes loads strictly
    from flax import serialization as flax_serialization
    path = tmp_path / "params.msgpack"
    path.write_bytes(flax_serialization.msgpack_serialize(
        jax.tree_util.tree_map(np.asarray, params)))
    restored = serialization.msgpack_restore(path.read_bytes())
    load(tmodel, restored)
    (x,) = rng_inputs(19, (3, 40))
    time = times(20, 3)
    ref = jax.jit(lambda v, x, time: jmodel.apply(
        v, x, time, jmodel.apply(v, x, method="encode")))(
            {"params": params}, jnp.asarray(x), jnp.asarray(time))
    got = tmodel(t_(x), t_(time), tmodel.encode(t_(x)))
    assert_model_close(got, ref)
    # port -> JAX: the tree the port writes is the Flax tree, leaf for leaf
    tree = weights.torch_to_flax(tmodel.state_dict(), tmodel.architecture)
    back = flax_serialization.msgpack_restore(
        serialization.msgpack_serialize(tree))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))


def test_unknown_architecture_raises_jax_value_error():
    _, tcfg = _configs("mlp")
    # the config refuses it when read, as the JAX package's validation does
    with pytest.raises(ValueError, match="architecture must be one of"):
        config_from_dict({"model": dict(tcfg.to_dict()["model"],
                                        architecture="transformer")})
    # and the factory, past the config's validation
    bad = config_from_dict({"model": tcfg.to_dict()["model"]})
    object.__setattr__(bad, "architecture", "transformer")
    with pytest.raises(ValueError, match="Unknown architecture"):
        create_flow_model(bad)
    with pytest.raises(TypeError):
        create_flow_model(config_from_dict({"model": dict(
            tcfg.to_dict()["model"], architecture_options={"channels": 4})}))


@pytest.mark.parametrize("name,count", [
    ("method=improved_mean_flow--architecture=mlp_mixer--dataset=audio--"
     "tokenization=mdct.json", 321_236_192),
    ("method=improved_mean_flow--architecture=mlp--dataset=audio--"
     "tokenization=mdct.json", 28_262_272),
    ("ablations/ablation--size=large.json", 86_005_000),
])
def test_full_width_param_counts_match_jax(name, count):
    """The configs the card trains at full width (chip_smoke.py's paths
    A-C) hold the parameters the JAX package counts (shapes only: the port
    builds on the meta device, JAX under eval_shape)."""
    import dataclasses
    from pathlib import Path

    from meanflow_audio_codec_tpu.configs import load_config_from_json
    from meanflow_audio_codec_tpu.training.trainer import (
        effective_noise_dimension as jax_effective_noise_dimension,
    )
    from meanflow_audio_codec_torch.configs import load_config
    from meanflow_audio_codec_torch.training.trainer import (
        effective_noise_dimension,
    )

    path = Path(__file__).resolve().parents[1] / "configs" / name
    jcfg = load_config_from_json(path)
    noise = jax_effective_noise_dimension(jcfg)
    jcfg.model.noise_dimension = noise
    jmodel = jax_create_flow_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, noise)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    cfg = load_config(path)
    cfg = dataclasses.replace(cfg,
                              noise_dimension=effective_noise_dimension(cfg))
    assert cfg.noise_dimension == noise
    with torch.device("meta"):
        model = create_flow_model(cfg)
    assert (sum(p.numel() for p in model.parameters())
            == jax_count_params(shapes) == count)
