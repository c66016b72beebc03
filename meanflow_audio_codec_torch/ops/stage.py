"""The ConvNeXt stage's three normalisation segments as fused ops.

Counterpart of ``meanflow_audio_codec_tpu/ops/stage_pallas.py``:

  1. lift 1x1 conv -> adaLN-norm -> FiLM   (:func:`fused_ln_film`)
  2. 3x3 conv      -> adaLN-norm            (:func:`fused_ln_norm`)
  3. expand 1x1    -> GELU -> GRN           (:func:`fused_gelu_grn`)

The plain PyTorch versions (``_ln_film_ref``, ``_ln_norm_ref``,
``_gelu_grn_ref`` in ``ops/stage_ref.py``) compute each segment and its
statistics in float32; the hand-written CUDA kernels of ``ops/stage_cuda.py``
(``csrc/stage.cu``) compute the same in one pass over device memory.

The mean-flow objectives (``training/objectives.py``) need reverse mode of a
plain forward, forward mode (``torch.autograd.forward_ad``) of the model and,
without the stop-gradient, reverse mode through that forward mode. The ops
meet all three as the JAX package's do:

  * a stats function (``_LnFilmStats``, ...; an ``autograd.Function``) runs
    the kernel on a CUDA tensor and the plain version on a CPU tensor, and
    returns the output with its statistics (``mu``, ``r`` / ``gx``); its
    backward is autograd through the plain version on the saved inputs, for
    the output and the statistics alike (JAX's ``custom_vjp`` stats
    functions, whose backward is ``jax.vjp`` of the jnp reference);
  * the public op runs the stats function on the primal. When its input
    carries a forward-mode tangent, it computes the tangent with the two-pass
    rule of the JAX package, in torch ops on those statistics (the kernel
    does not run a second time), and returns a dual tensor.

The tangent rule runs under ``torch.no_grad()`` unless
:func:`differentiable_tangents` is in force, so the stop-gradient objectives
keep none of its float32 intermediates; inside it, the rule is recorded like
any torch op, so a gradient reaches the inputs and parameters through the
tangent and through the statistics (grad-of-JVP, JAX's ``custom_jvp`` rule
differentiated).

:func:`inference_on_card` is the rule by which the models run these ops
where ``fused_stage`` is off: a forward on the card that nothing
differentiates. Each call of an op adds 1 to the count ``stage_fused`` of
the innermost open span (``tracing``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.autograd.forward_ad as fwAD

from meanflow_audio_codec_torch import tracing
from meanflow_audio_codec_torch.ops import stage_cuda
from meanflow_audio_codec_torch.ops.stage_ref import (
    _GRN_MEAN_EPS,
    _gelu_f32,
    _gelu_grad_f32,
    _gelu_grn_ref,
    _ln_film_ref,
    _ln_norm_ref,
)

_TANGENT_GRAD = contextvars.ContextVar("stage_tangent_grad", default=False)


@contextlib.contextmanager
def differentiable_tangents(enabled: bool = True):
    """Record the tangent rules for reverse mode (``enabled``) or run them
    under ``no_grad`` (the default) while the context lasts."""
    token = _TANGENT_GRAD.set(enabled)
    try:
        yield
    finally:
        _TANGENT_GRAD.reset(token)


def tangents_differentiable() -> bool:
    """Whether :func:`differentiable_tangents` is in force."""
    return _TANGENT_GRAD.get()


def inference_on_card(x: torch.Tensor) -> bool:
    """Whether a stage segment on the channels-last ``x`` [B, ..., C] takes
    the fused ops whatever ``fused_stage`` says: ``x`` is a CUDA tensor the
    kernels take (float32 or bfloat16, ``stage_cuda.takes``), autograd is
    not recording and no forward-mode dual level is open. Nothing then
    differentiates the segment, so the kernel's one forward pass is all it
    needs; a float16 or float64 forward keeps the plain path."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and fwAD._current_level < 0
            and stage_cuda.takes(math.prod(x.shape[1:-1]), x.shape[-1],
                                 x.dtype))


def _vjp(ctx, ref, grads):
    """Cotangents of the saved inputs through the plain version's outputs
    (``grads`` holds one per output, None where it received none)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(needs) for t, needs
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        pairs = [(out, g) for out, g in zip(ref(*leaves), grads)
                 if g is not None]
        if not pairs:
            return (None,) * len(leaves)
        found = iter(torch.autograd.grad([out for out, _ in pairs], wanted,
                                         [g for _, g in pairs]))
    return tuple(next(found) if t.requires_grad else None for t in leaves)


class _LnFilmStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, scale, shift):
        x3, scale, shift = (t.contiguous() for t in (x3, scale, shift))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x3, scale, shift)
        return stage_cuda.ln_film_cuda(x3, scale, shift)

    @staticmethod
    def backward(ctx, *grads):
        return _vjp(ctx, _ln_film_ref, grads)


class _LnNormStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3):
        x3 = x3.contiguous()
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x3)
        return stage_cuda.ln_norm_cuda(x3)

    @staticmethod
    def backward(ctx, *grads):
        return _vjp(ctx, _ln_norm_ref, grads)


class _GeluGrnStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, gamma, beta):
        x3 = x3.contiguous()
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x3, gamma, beta)
        return stage_cuda.gelu_grn_cuda(x3, gamma, beta)

    @staticmethod
    def backward(ctx, *grads):
        return _vjp(ctx, _gelu_grn_ref, grads)


def _ln_tangent(xhat: torch.Tensor, r3: torch.Tensor,
                tx: torch.Tensor) -> torch.Tensor:
    """Tangent of x̂ = (x - mean x) r along ``tx``, float32.

    x̂ has zero mean per row, so mean(x̂ (tx - mean tx)) = mean(x̂ tx): one
    reduce pass over (x, tx), one apply pass."""
    tx32 = tx.float()
    tmu = tx32.mean(dim=-1, keepdim=True)
    proj = (xhat * tx32).mean(dim=-1, keepdim=True)
    return r3 * (tx32 - tmu) - xhat * (r3 * proj)


def _ln_film_tangent(primals, tangents, stats):
    (x3, scale, _), (tx, ts, tb), (mu, r) = primals, tangents, stats
    r3 = r[..., None]
    xhat = (x3.float() - mu[..., None]) * r3
    ty = (1.0 + scale.float()[:, None, :]) * _ln_tangent(xhat, r3, tx)
    if ts is not None:
        ty = ty + ts.float()[:, None, :] * xhat
    if tb is not None:
        ty = ty + tb.float()[:, None, :]
    return ty


def _ln_norm_tangent(primals, tangents, stats):
    (x3,), (tx,), (mu, r) = primals, tangents, stats
    r3 = r[..., None]
    return _ln_tangent((x3.float() - mu[..., None]) * r3, r3, tx)


def _gelu_grn_tangent(primals, tangents, stats):
    (x3, gamma, _), (tx, tgamma, tbeta), (gx,) = primals, tangents, stats
    x32 = x3.float()
    # g is recomputed elementwise; the statistic gx comes from the primal
    g = _gelu_f32(x32)
    tg = _gelu_grad_f32(x32) * tx.float()
    m = gx.mean(dim=-1, keepdim=True) + _GRN_MEAN_EPS
    nx = gx / m
    tgx = (g * tg).sum(dim=1) / gx
    tnx = (tgx - nx * tgx.mean(dim=-1, keepdim=True)) / m
    ty = tg * (gamma.float() + nx[:, None, :]) + g * tnx[:, None, :]
    if tgamma is not None:
        ty = ty + g * tgamma.float()
    if tbeta is not None:
        ty = ty + tbeta.float()
    return ty


def _apply(stats_fn, tangent_rule, *inputs):
    """``stats_fn`` on the primals of ``inputs``; a dual output whose tangent
    is ``tangent_rule``'s when any input carries a tangent."""
    if tracing.ON:
        tracing.count("stage_fused", 1)
    unpacked = [fwAD.unpack_dual(t) for t in inputs]
    primals = [u.primal for u in unpacked]
    tangents = [u.tangent for u in unpacked]
    y, *stats = stats_fn.apply(*primals)
    if all(t is None for t in tangents):
        return y
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and _TANGENT_GRAD.get()):
        ty = tangent_rule(primals, tangents, stats)
    return fwAD.make_dual(y, ty.to(y.dtype))


def fused_ln_film(x3: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """adaLN-norm + FiLM in one pass: ``normalize(x) * (1 + scale) + shift``.

    ``x3`` is [B, P, C] (P = flattened spatial positions); ``scale`` and
    ``shift`` are [B, C], broadcast over P. Statistics in float32; the
    result in ``x3``'s dtype.
    """
    return _apply(_LnFilmStats, _ln_film_tangent, x3, scale, shift)


def fused_ln_norm(x3: torch.Tensor) -> torch.Tensor:
    """adaLN-norm (scale- and bias-free LayerNorm over C, float32 statistics)
    of [B, P, C] in one pass."""
    return _apply(_LnNormStats, _ln_norm_tangent, x3)


def fused_gelu_grn(x3: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """tanh-GELU + ConvNeXt-V2 GRN of the pre-activation ``x3`` [B, P, C] in
    one pass, with the GRN parameters ``gamma``/``beta`` [C]; float32
    accumulation, the result in ``x3``'s dtype."""
    return _apply(_GeluGrnStats, _gelu_grn_tangent, x3, gamma, beta)


def stage_fusable(spatial: int, channels: int,
                  dtype: torch.dtype = torch.bfloat16) -> bool:
    """True when the ``[B, spatial**2, channels]`` geometry of ``dtype``
    runs the three stage kernels on the card (the GELU+GRN on its
    ``2 * channels`` expansion): float32 or bfloat16 at any ``spatial`` and
    ``channels`` from 1 up to the kernels' int extents (``stage_cuda.takes``,
    the rule the wrappers enforce).

    The JAX package's rule (``stage_pallas.stage_fusable``) is the TPU's
    lane alignment: channels a multiple of 128 and spatial**2 of 16, any
    other geometry taking its jnp reference. The CUDA kernels tile by rows
    and read any C and P, so every geometry the JAX rule admits is fusable
    here too, and so are the unaligned ones it sends to the reference
    (channels 64 at spatial 4, say).
    """
    return (spatial > 0 and channels > 0
            and stage_cuda.takes(spatial * spatial, 2 * channels, dtype))
