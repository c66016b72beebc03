"""PyTorch port: ``ReshapeTokenization``, the token-shape helpers, the
pipeline, the features layout of the token adapter and the FFT MDCT/IMDCT
against the JAX package.

Tolerances: the reshape tokenizer moves values without arithmetic, so its
tokens and round trips are compared exactly. The FFT transforms at W 4096
run in float32 (complex64) on both sides: rtol 1e-4 / atol 1e-3 against
JAX's ``mdct_fft``/``imdct_fft`` and against the port's direct path, the
tolerance of the MDCT kernel checks — coefficients of a unit-variance
signal reach ~100 at this W, and a 2W-point FFT and a 2W-term dot product
round differently in the last bits (read ~2e-4 absolute).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.ops import tokenize as jtok
from meanflow_audio_codec_tpu.training.trainer import TokenAdapter as JaxAdapter
from meanflow_audio_codec_torch.ops import tokenize as ttok
from meanflow_audio_codec_torch.training.adapter import TokenAdapter

jmdct = importlib.import_module("meanflow_audio_codec_tpu.ops.mdct")
# the module: the package's ``mdct`` is the function, as in the JAX package
tmdct = importlib.import_module("meanflow_audio_codec_torch.ops.mdct")

FFT_TOL = dict(rtol=1e-4, atol=1e-3)

# label -> (tokenizer kwargs, input shape)
RESHAPE_CASES = {
    "mnist_flat_heuristic": ({}, (3, 784)),
    "image_patch_size": ({"patch_size": 7}, (2, 784)),
    "image_rect_patch": ({"patch_size": (2, 4), "image_size": (8, 12)},
                         (2, 96)),
    "image_hw": ({"patch_size": 4}, (2, 8, 8)),
    "image_nhwc": ({"patch_size": 2}, (2, 6, 6, 3)),
    "image_gray_channel": ({}, (2, 8, 8, 1)),
    "audio_default_patch": ({}, (2, 1000)),
    "audio_patch_length_padded": ({"patch_length": 96}, (2, 1000)),
    "audio_stereo_padded": ({"patch_length": 128}, (2, 300, 2)),
}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("case", list(RESHAPE_CASES))
def test_reshape_tokenization_matches_jax(case):
    kwargs, shape = RESHAPE_CASES[case]
    x = _x(shape)
    ours = ttok.ReshapeTokenization(**kwargs)
    ref = jtok.ReshapeTokenization(**kwargs)
    tokens = ours.tokenize(torch.from_numpy(x))
    jtokens = ref.tokenize(jnp.asarray(x))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(ours.detokenize(tokens).numpy(),
                                  np.asarray(ref.detokenize(jtokens)))
    assert (ttok.compute_token_shape(ours, shape[1:])
            == jtok.compute_token_shape(ref, shape[1:]))
    assert (ttok.compute_tokenized_dimension(ours, shape[1:])
            == jtok.compute_tokenized_dimension(ref, shape[1:]))


@pytest.mark.parametrize("patch_dim", [4, 9, 12, 16, 49, 50, 98, 128])
def test_inferred_patch_geometry_matches_jax(patch_dim):
    assert (ttok.ReshapeTokenization()._infer_patch_geometry(patch_dim)
            == jtok.ReshapeTokenization()._infer_patch_geometry(patch_dim))


def test_patchify_round_trip_and_layout():
    x = _x((2, 8, 12, 3), seed=1)
    tokens = ttok.patchify_image(torch.from_numpy(x), 4, 2)
    np.testing.assert_array_equal(
        tokens.numpy(), np.asarray(jtok.patchify_image(jnp.asarray(x), 4, 2)))
    back = ttok.unpatchify_image(tokens, 2, 6, 4, 2, 3)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("strategy,config,shape", [
    ("mdct", {"window_size": 64}, (2048, 2)),
    ("mdct", {"window_size": 512, "hop_size": 128}, (784,)),
    ("reshape", {}, (784,)),
    ("reshape", {"patch_length": 128}, (512, 2)),
    (None, {}, (65536, 2)),
])
def test_create_strategy_and_token_shape_match_jax(strategy, config, shape):
    ours = ttok.create_tokenization_strategy(strategy, config)
    ref = jtok.create_tokenization_strategy(strategy, config)
    assert type(ours).__name__ == type(ref).__name__
    assert (ttok.compute_token_shape(ours, shape)
            == jtok.compute_token_shape(ref, shape))


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="Unknown tokenization"):
        ttok.create_tokenization_strategy("wavelet")


def test_pipeline_applies_in_order_and_reverses():
    x = _x((2, 784), seed=2)
    steps = [ttok.ReshapeTokenization(patch_size=7)]
    pipe = ttok.PreprocessingPipeline(steps)
    jpipe = jtok.PreprocessingPipeline([jtok.ReshapeTokenization(patch_size=7)])
    tokens = pipe.tokenize(torch.from_numpy(x))
    np.testing.assert_array_equal(tokens.numpy(),
                                  np.asarray(jpipe.tokenize(jnp.asarray(x))))
    np.testing.assert_array_equal(pipe.detokenize(tokens).numpy(),
                                  x.reshape(2, 28, 28))


@pytest.mark.parametrize("gain_norm", [0.0, 0.05])
def test_features_adapter_matches_jax(gain_norm):
    """The features layout: one flat example per clip, one gain per clip."""
    x = _x((3, 784), seed=3)
    strategy = ttok.ReshapeTokenization()
    ours = TokenAdapter(strategy, 2.0, gain_norm, mode="features")
    ref = JaxAdapter(jtok.ReshapeTokenization(), "features", scale=2.0,
                     gain_norm=gain_norm)
    flat, gains = ours.tokenize_with_gain(torch.from_numpy(x))
    jflat, jgains = ref.tokenize_with_gain(jnp.asarray(x))
    assert flat.shape == (3, 784)
    # with gain_norm one gain per clip; without, ones per token (as JAX)
    assert gains.shape == jgains.shape == ((3, 1, 1) if gain_norm
                                           else (3, 49, 1))
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=1e-6)
    np.testing.assert_allclose(gains.numpy(), np.asarray(jgains), rtol=1e-6)
    back = ours.detokenize_flat(flat, (49, 16), gains=gains)
    jback = ref.detokenize_flat(jflat, (49, 16), gains=jgains)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x.reshape(3, 28, 28), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the FFT MDCT / IMDCT
# ---------------------------------------------------------------------------

W_FFT = 4096


@pytest.mark.parametrize("hop", [None, 1024])
def test_fft_mdct_matches_jax_and_the_direct_path(hop):
    cfg = tmdct.MDCTConfig(W_FFT, hop)
    x = _x((2, 3 * W_FFT + 100), seed=4)
    got = tmdct.mdct(torch.from_numpy(x), cfg)  # W >= 4096: the FFT path
    np.testing.assert_allclose(got.numpy(), tmdct.mdct_fft(
        torch.from_numpy(x), cfg).numpy(), rtol=0, atol=0)
    ref = jmdct.mdct_fft(jnp.asarray(x), W_FFT, hop)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FFT_TOL)
    direct = tmdct.mdct_direct(torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **FFT_TOL)


@pytest.mark.parametrize("hop,normalize", [(None, False), (1024, True)])
def test_fft_imdct_matches_jax_and_the_direct_path(hop, normalize):
    cfg = tmdct.MDCTConfig(W_FFT, hop, normalize)
    X = _x((2, 3, W_FFT), seed=5)
    got = tmdct.imdct(torch.from_numpy(X), cfg)
    np.testing.assert_allclose(got.numpy(), tmdct.imdct_fft(
        torch.from_numpy(X), cfg).numpy(), rtol=0, atol=0)
    jcfg = jmdct.MDCTConfig(W_FFT, cfg.hop_size, normalize=normalize)
    ref = jmdct.imdct(jnp.asarray(X), config=jcfg)  # the FFT path off the TPU
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FFT_TOL)
    direct = tmdct.imdct_direct(torch.from_numpy(X), cfg)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **FFT_TOL)


def test_threshold_picks_the_path():
    assert (tmdct.DEFAULT_FFT_THRESHOLD == jmdct.DEFAULT_FFT_THRESHOLD
            == tmdct.MDCTConfig().use_fft_threshold == 4096)
    x = torch.from_numpy(_x((1, 600), seed=6))
    cfg = tmdct.MDCTConfig(64, use_fft_threshold=128)
    X = tmdct.mdct_direct(x, cfg)
    np.testing.assert_array_equal(tmdct.mdct(x, cfg).numpy(),
                                  tmdct.mdct_direct(x, cfg).numpy())
    np.testing.assert_array_equal(tmdct.imdct(X, cfg).numpy(),
                                  tmdct.imdct_direct(X, cfg).numpy())
    cfg = tmdct.MDCTConfig(64, use_fft_threshold=64)
    np.testing.assert_array_equal(tmdct.mdct(x, cfg).numpy(),
                                  tmdct.mdct_fft(x, cfg).numpy())
    np.testing.assert_array_equal(tmdct.imdct(X, cfg).numpy(),
                                  tmdct.imdct_fft(X, cfg).numpy())
