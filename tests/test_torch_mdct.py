"""PyTorch port: MDCT/IMDCT plain versions and the tokenizer against the JAX
package (direct path and Pallas kernels in interpret mode) and the NumPy
oracles.

Tolerance: rtol 1e-4 / atol 1e-3, the transform contract of
tests/test_mdct.py. Both sides compute in float32 from the same float32
windowed basis; only the summation order differs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.ops.imdct_pallas import imdct_pallas
from meanflow_audio_codec_tpu.ops.mdct_pallas import mdct_pallas
from meanflow_audio_codec_tpu.ops.tokenize import (
    MDCTTokenization as JaxMDCTTokenization,
)
from meanflow_audio_codec_torch.ops import imdct_cuda as imdct_cuda_mod
from meanflow_audio_codec_torch.ops import mdct_cuda as mdct_cuda_mod
from meanflow_audio_codec_torch.ops.imdct_cuda import imdct_cuda
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    _windowed_basis_np,
    imdct,
    mdct,
    num_frames_for_length,
    output_length,
    windowed_basis,
)
from meanflow_audio_codec_torch.ops.mdct_cuda import mdct_cuda
from meanflow_audio_codec_torch.ops.tokenize import (
    MDCTTokenization,
    create_tokenization_strategy,
)
from oracles import imdct_baseline, mdct_baseline

# the package re-exports a function named mdct over the module name
jmdct = importlib.import_module("meanflow_audio_codec_tpu.ops.mdct")

RTOL, ATOL = 1e-4, 1e-3

# tests/test_mdct_pallas.py geometries, shortened
GEOMETRIES = [
    (8, 4800, 576, 288),
    (3, 2000, 256, 128),
    (2, 2500, 576, 100),   # hop does not divide 2W
    (1, 2000, 128, 64),
]


def _signal(rows, length, seed):
    return np.random.default_rng(seed).standard_normal(
        (rows, length)).astype(np.float32)


@pytest.mark.parametrize("rows,length,window,hop", GEOMETRIES)
def test_mdct_matches_jax_pallas_and_oracle(rows, length, window, hop):
    x = _signal(rows, length, rows + window)
    got = mdct(torch.from_numpy(x), MDCTConfig(window, hop)).numpy()
    for ref in (np.asarray(jmdct.mdct_direct(jnp.asarray(x), window, hop)),
                np.asarray(mdct_pallas(jnp.asarray(x), window, hop,
                                       interpret=True)),
                mdct_baseline(x, window, hop)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,length,window,hop", GEOMETRIES)
def test_imdct_matches_jax_pallas_and_oracle(rows, length, window, hop):
    nf = num_frames_for_length(length, window, hop)
    X = np.random.default_rng(rows + hop).standard_normal(
        (rows, nf, window)).astype(np.float32)
    got = imdct(torch.from_numpy(X), MDCTConfig(window, hop)).numpy()
    for ref in (np.asarray(jmdct.imdct_direct(jnp.asarray(X), window, hop)),
                np.asarray(imdct_pallas(jnp.asarray(X), window, hop,
                                        interpret=True)),
                imdct_baseline(X, window, hop)):
        assert got.shape == ref.shape == (rows, output_length(nf, window, hop))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_imdct_normalize_matches_jax(normalize):
    X = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(np.float32)
    got = imdct(torch.from_numpy(X), MDCTConfig(64, 32, normalize)).numpy()
    ref = jmdct.imdct(jnp.asarray(X),
                      config=jmdct.MDCTConfig(64, 32, normalize=normalize))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window,hop", [(64, 32), (128, 64), (576, 288)])
def test_roundtrip_reconstructs_w_over_hop_gain(window, hop):
    """The reference convention: normalize=False reconstructs W/hop x."""
    x = _signal(2, 40 * hop, window)
    cfg = MDCTConfig(window, hop)
    y = imdct(mdct(torch.from_numpy(x), cfg), cfg).numpy()
    inner = slice(2 * window, 38 * hop)  # frames fully overlapped there
    np.testing.assert_allclose(y[:, inner], window / hop * x[:, inner],
                               rtol=RTOL, atol=ATOL)
    y = imdct(mdct(torch.from_numpy(x), MDCTConfig(window, hop, True)),
              MDCTConfig(window, hop, True)).numpy()
    np.testing.assert_allclose(y[:, inner], x[:, inner], rtol=RTOL, atol=ATOL)


def test_config_and_shape_helpers_match_jax():
    assert MDCTConfig(512).hop_size == 256
    assert MDCTConfig().window_size == jmdct.MDCTConfig().window_size
    assert MDCTConfig().normalize is False
    with pytest.raises(ValueError):
        MDCTConfig(0)
    for length, window, hop in [(100, 512, 256), (32768, 512, 256),
                                (5000, 576, 100), (512, 512, 256)]:
        assert (num_frames_for_length(length, window, hop)
                == jmdct.num_frames_for_length(length, window, hop))
        assert output_length(7, window, hop) == jmdct.output_length(7, window,
                                                                     hop)


@pytest.mark.parametrize("window", [64, 512, 576])
def test_windowed_basis_is_bitwise_the_jax_constant(window):
    ref = jmdct._windowed_basis_np(window)
    np.testing.assert_array_equal(_windowed_basis_np(window), ref)
    basis = windowed_basis(window)
    basis_t = windowed_basis(window, transposed=True)
    # the CUDA kernels read both as dense row-major arrays
    assert basis.is_contiguous() and basis_t.is_contiguous()
    np.testing.assert_array_equal(basis.numpy(), ref)
    np.testing.assert_array_equal(basis_t.numpy(), ref.T)


@pytest.mark.parametrize("channels", [1, 2])
def test_tokenizer_matches_jax(channels):
    rng = np.random.default_rng(channels)
    shape = (3, 1000) if channels == 1 else (3, 1000, channels)
    audio = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    tok, jtok = MDCTTokenization(64), JaxMDCTTokenization(64, use_pallas=False)
    tokens = tok.tokenize(torch.from_numpy(audio))
    ref = np.asarray(jtok.tokenize(jnp.asarray(audio)))
    assert tokens.shape == ref.shape
    np.testing.assert_allclose(tokens.numpy(), ref, rtol=RTOL, atol=ATOL)
    back = tok.detokenize(tokens).numpy()
    ref_back = np.asarray(jtok.detokenize(jnp.asarray(ref)))
    assert back.shape == ref_back.shape
    np.testing.assert_allclose(back, ref_back, rtol=RTOL, atol=ATOL)


def test_tokenizer_rejects_bad_shapes():
    tok = MDCTTokenization(64)
    with pytest.raises(ValueError):
        tok.tokenize(torch.zeros(2, 3, 4, 5))
    with pytest.raises(ValueError):
        tok.detokenize(torch.zeros(2, 3, 100))
    with pytest.raises(ValueError):
        create_tokenization_strategy("reshape")
    assert create_tokenization_strategy(None, {"window_size": 32}).config == \
        MDCTConfig(32, 16)


def test_wrappers_run_plain_versions_on_cpu_without_launching():
    x = torch.from_numpy(_signal(2, 3000, 7))
    cfg = MDCTConfig(256, 128)
    before = (mdct_cuda_mod.launches, imdct_cuda_mod.launches)
    coeffs = mdct_cuda(x, cfg)
    torch.testing.assert_close(coeffs, mdct(x, cfg), rtol=0, atol=0)
    torch.testing.assert_close(imdct_cuda(coeffs, cfg), imdct(coeffs, cfg),
                               rtol=0, atol=0)
    assert (mdct_cuda_mod.launches, imdct_cuda_mod.launches) == before


def test_wrappers_reject_other_devices():
    x = torch.empty(2, 3000, device="meta")
    with pytest.raises(ValueError):
        mdct_cuda(x, MDCTConfig(256))
    with pytest.raises(ValueError):
        imdct_cuda(torch.empty(2, 5, 256, device="meta"), MDCTConfig(256))
