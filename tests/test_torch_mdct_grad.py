"""PyTorch port: the MDCT/IMDCT backward rules of the card wrappers, the MDCT
layers, ``sine_window`` and the pipeline helpers, against the JAX package.

The card wrappers' ``autograd.Function`` s (``MDCTFunction``,
``IMDCTFunction``) launch the CUDA kernels, which do not run here. Their
backward rules are the code under test: here each ``launch`` is replaced by
the plain computation of its kernel (framing + basis product; basis
product + overlap-add at the given scale), in the input's dtype, and the
rules run as they do on the card. They are held

  * against ``jax.vjp`` of ``mdct_pallas`` / ``imdct_pallas`` with
    ``interpret=True`` (JAX's ``custom_vjp``, as tests/test_mdct_pallas.py
    runs it) at float32, rtol 1e-5 / atol 1e-4 (the same f32 products,
    summed in another order). JAX's IMDCT rule returns a W-wide cotangent
    for coefficients it lane-padded to a multiple of 128, so ``jax.vjp``
    raises for other W: the IMDCT cases take W 128 and 256;
  * by the adjoint identity ``<F(x), g> = <x, F^T(g)>`` in float64, to 1e-12
    relative: the rule is the transform's exact adjoint, with no cut or
    padding of its own.

On the card ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
kernels' gradients against the plain version's autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.ops import IMDCTLayer as JaxIMDCTLayer
from meanflow_audio_codec_tpu.ops import MDCTLayer as JaxMDCTLayer
from meanflow_audio_codec_tpu.ops import sine_window as jax_sine_window
from meanflow_audio_codec_tpu.ops.imdct_pallas import imdct_pallas
from meanflow_audio_codec_tpu.ops.mdct import MDCTConfig as JaxMDCTConfig
from meanflow_audio_codec_tpu.ops.mdct_pallas import mdct_pallas
from meanflow_audio_codec_tpu.ops.tokenize import (
    ReshapeTokenization as JaxReshapeTokenization,
)
from meanflow_audio_codec_tpu.ops.tokenize import (
    create_mdct_pipeline as jax_create_mdct_pipeline,
)
from meanflow_audio_codec_torch.ops import imdct_cuda, mdct_cuda
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    _frame,
    _overlap_add,
    _prepare_signal,
    _windowed_basis_np,
    output_length,
    sine_window,
)
from meanflow_audio_codec_torch.ops.mdct_layers import IMDCTLayer, MDCTLayer
from meanflow_audio_codec_torch.ops.tokenize import (
    Compose,
    MDCTTokenization,
    PreprocessingPipeline,
    ReshapeTokenization,
    create_mdct_pipeline,
    create_reshape_pipeline,
)


def _basis(w, dtype):
    return torch.from_numpy(np.array(_windowed_basis_np(w))).to(dtype)


def _plain_mdct_launch(x2d, w, hop):
    x, nf, _ = _prepare_signal(x2d, w, hop)
    return _frame(x, nf, w, hop) @ _basis(w, x2d.dtype)


def _plain_imdct_launch(x3d, w, hop, scale):
    frames = scale * (x3d @ _basis(w, x3d.dtype).T)
    return _overlap_add(frames, hop, output_length(x3d.shape[1], w, hop))


@pytest.fixture
def plain_launches(monkeypatch):
    """The card functions' launches, run as their kernels' plain
    computation on the CPU."""
    monkeypatch.setattr(mdct_cuda, "launch", _plain_mdct_launch)
    monkeypatch.setattr(imdct_cuda, "launch", _plain_imdct_launch)


def _grad(fn, x, cot):
    x = x.clone().requires_grad_(True)
    (fn(x) * cot).sum().backward()
    return x.grad


@pytest.mark.parametrize("batch,length,window,hop", [
    (2, 3000, 256, 128), (3, 700, 64, 24), (1, 100, 128, 64)])
def test_mdct_backward_rule_matches_jax_vjp(plain_launches, batch, length,
                                            window, hop):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((batch, length)).astype(np.float32)
    nf = max(1, (length - window) // hop + 1)
    cot = rng.standard_normal((batch, nf, window)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: mdct_pallas(a, window, hop, interpret=True),
                     jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(cot))[0])
    got = _grad(lambda a: mdct_cuda.MDCTFunction.apply(a, window, hop),
                torch.from_numpy(x), torch.from_numpy(cot))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # and the plain version's autograd, which the card is held against
    plain = _grad(lambda a: mdct_cuda.mdct_cuda(a, MDCTConfig(window, hop)),
                  torch.from_numpy(x), torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("batch,frames,window,hop", [
    (2, 21, 256, 128), (3, 5, 128, 48)])
def test_imdct_backward_rule_matches_jax_vjp(plain_launches, batch, frames,
                                             window, hop, normalize):
    rng = np.random.default_rng(frames + normalize)
    X = rng.standard_normal((batch, frames, window)).astype(np.float32)
    cot = rng.standard_normal(
        (batch, output_length(frames, window, hop))).astype(np.float32)
    jcfg = JaxMDCTConfig(window_size=window, hop_size=hop,
                         normalize=normalize)
    _, vjp = jax.vjp(lambda a: imdct_pallas(a, config=jcfg, interpret=True),
                     jnp.asarray(X))
    ref = np.asarray(vjp(jnp.asarray(cot))[0])
    cfg = MDCTConfig(window, hop, normalize)
    scale = imdct_cuda.imdct_scale(cfg)
    got = _grad(lambda a: imdct_cuda.IMDCTFunction.apply(a, window, hop,
                                                         scale),
                torch.from_numpy(X), torch.from_numpy(cot))
    assert got.shape == X.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    plain = _grad(lambda a: imdct_cuda.imdct_cuda(a, cfg),
                  torch.from_numpy(X), torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("length,window,hop", [(3000, 256, 128),
                                               (513, 64, 40), (50, 64, 32)])
def test_backward_rules_are_exact_adjoints_in_float64(plain_launches, length,
                                                      window, hop):
    """<mdct(x), g> = <x, mdct_vjp(g)> and <imdct(X), y> = <X,
    imdct_vjp(y)>, float64, through the rules and their second-order
    (the MDCT's rule runs the IMDCT's forward and the other way round)."""
    rng = np.random.default_rng(length)
    x = torch.from_numpy(rng.standard_normal((2, length)))
    coeffs = mdct_cuda.MDCTFunction.apply(x, window, hop)
    g = torch.from_numpy(rng.standard_normal(coeffs.shape))
    dx = _grad(lambda a: mdct_cuda.MDCTFunction.apply(a, window, hop), x, g)
    lhs, rhs = (coeffs * g).sum(), (x * dx).sum()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    scale = 2.0 / window
    X = torch.from_numpy(rng.standard_normal(coeffs.shape))
    signal = imdct_cuda.IMDCTFunction.apply(X, window, hop, scale)
    y = torch.from_numpy(rng.standard_normal(signal.shape))
    dX = _grad(lambda a: imdct_cuda.IMDCTFunction.apply(a, window, hop,
                                                        scale), X, y)
    lhs, rhs = (signal * y).sum(), (X * dX).sum()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    # the backward is differentiable in its cotangent: d<x, F^T g>/dg = F(x)
    x1, g1 = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    (dx1,) = torch.autograd.grad(
        (mdct_cuda.MDCTFunction.apply(x1, window, hop) * g1).sum(), x1,
        create_graph=True)
    (dg,) = torch.autograd.grad((dx1 * x).sum(), g1)
    assert torch.allclose(dg, coeffs, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# layers, window, pipelines
# ---------------------------------------------------------------------------


def test_mdct_layers_mono_and_stereo_match_jax():
    rng = np.random.default_rng(9)
    fwd, inv = MDCTLayer(128, 64), IMDCTLayer(128, 64)
    jfwd = JaxMDCTLayer(window_size=128, hop_size=64)
    jinv = JaxIMDCTLayer(window_size=128, hop_size=64)
    mono = rng.standard_normal((2, 2048)).astype(np.float32)
    stereo = rng.standard_normal((2, 2048, 2)).astype(np.float32)
    for audio, width in ((mono, 128), (stereo, 256)):
        X = fwd(torch.from_numpy(audio))
        assert X.shape[-1] == width
        ref = jfwd.apply({}, jnp.asarray(audio))
        np.testing.assert_allclose(X.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
        y = inv(X)
        np.testing.assert_allclose(y.numpy(), np.asarray(jinv.apply({}, ref)),
                                   rtol=1e-4, atol=1e-4)
    assert y.shape[-1] == 2
    # channel-major: the first 128 coefficients are the left channel
    np.testing.assert_allclose(
        X[..., :128].numpy(), fwd(torch.from_numpy(stereo[..., 0])).numpy(),
        rtol=1e-5, atol=1e-5)


def test_mdct_layers_carry_gradients():
    stereo = torch.randn(2, 1024, 2, requires_grad=True)
    fwd, inv = MDCTLayer(128, 64), IMDCTLayer(128, 64)
    inv(fwd(stereo)).square().sum().backward()
    assert stereo.grad is not None and torch.isfinite(stereo.grad).all()
    assert stereo.grad.abs().sum() > 0


def test_sine_window_princen_bradley_and_jax():
    w = sine_window(512)
    assert w.shape == (512,) and w.dtype == torch.float32
    np.testing.assert_allclose(w[:256].numpy() ** 2 + w[256:].numpy() ** 2,
                               1.0, atol=1e-5)
    # within an ulp of JAX's (XLA's and PyTorch's float32 sin differ)
    np.testing.assert_allclose(w.numpy(), np.asarray(jax_sine_window(512)),
                               rtol=0, atol=1.2e-7)
    with pytest.raises(ValueError, match="positive"):
        sine_window(0)


def test_pipeline_compose_inverse_order():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 28, 28)).astype(np.float32)
    pipeline = Compose(ReshapeTokenization(patch_size=7, image_size=28))
    assert isinstance(pipeline, PreprocessingPipeline)
    tokens = pipeline.tokenize(torch.from_numpy(x))
    ref = JaxReshapeTokenization(patch_size=7, image_size=28).tokenize(
        jnp.asarray(x))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(pipeline.detokenize(tokens).numpy(), x)


def test_create_pipelines_match_jax():
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, 4096, 2)).astype(np.float32)
    pipeline = create_mdct_pipeline(256)
    (step,) = pipeline.steps
    assert isinstance(step, MDCTTokenization)
    assert step.config == MDCTConfig(256, 128)
    tokens = pipeline.tokenize(torch.from_numpy(audio))
    ref = jax_create_mdct_pipeline(256).tokenize(jnp.asarray(audio))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    reshape = create_reshape_pipeline(patch_size=7, image_size=28)
    (step,) = reshape.steps
    assert (step.patch_size, step.patch_length, step.image_size) == (7, None,
                                                                      28)
