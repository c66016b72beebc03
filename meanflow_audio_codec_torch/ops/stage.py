"""The ConvNeXt stage's three normalisation segments as fused ops.

Counterpart of ``meanflow_audio_codec_tpu/ops/stage_pallas.py``:

  1. lift 1x1 conv -> adaLN-norm -> FiLM   (:func:`fused_ln_film`)
  2. 3x3 conv      -> adaLN-norm            (:func:`fused_ln_norm`)
  3. expand 1x1    -> GELU -> GRN           (:func:`fused_gelu_grn`)

The plain PyTorch versions (``_ln_film_ref``, ``_ln_norm_ref``,
``_gelu_grn_ref`` in ``ops/stage_ref.py``) compute each segment and its
statistics in float32; the hand-written CUDA kernels of ``ops/stage_cuda.py``
(``csrc/stage.cu``) compute the same in one pass over device memory.

Each public op is a ``torch.autograd.Function`` that serves the iMF objective
(``training/objectives.py``), which needs reverse mode of a plain forward and
forward mode (``torch.autograd.forward_ad``) of the model:

  * ``forward`` runs the kernel on a CUDA tensor and the plain version on a CPU
    tensor, and keeps the statistics it emits (``mu``, ``r`` / ``gx``);
  * ``jvp`` is the two-pass tangent rule of the JAX package, written in torch,
    reusing those statistics: the kernel does not run a second time;
  * ``backward`` is autograd through the plain version on the saved inputs,
    as the JAX package's VJP is ``jax.vjp`` of its jnp reference.

The tangent is not differentiable: ``jvp`` runs under ``torch.no_grad()``
(so autograd keeps none of its float32 intermediates) and reads the saved
statistics as constants. Gradient-of-JVP (``use_stop_gradient=False``) is
therefore not supported by these ops.
"""

from __future__ import annotations

import torch

from meanflow_audio_codec_torch.ops import stage_cuda
from meanflow_audio_codec_torch.ops.stage_ref import (
    _GRN_MEAN_EPS,
    _gelu_f32,
    _gelu_grad_f32,
    _gelu_grn_ref,
    _ln_film_ref,
    _ln_norm_ref,
)


def _vjp(ctx, ref, grad_y):
    """Cotangents of the saved inputs through the plain version's ``y``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(needs) for t, needs
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(ref(*leaves)[0], wanted, grad_y))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class _LnFilm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, scale, shift):
        x3, scale, shift = (t.contiguous() for t in (x3, scale, shift))
        y, mu, r = stage_cuda.ln_film_cuda(x3, scale, shift)
        ctx.save_for_backward(x3, scale, shift)
        ctx.save_for_forward(x3, scale, mu, r)
        return y

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, tx, ts, tb):
        x3, scale, mu, r = ctx.saved_tensors
        # x̂ has zero mean per row, so mean(x̂ (tx - mean tx)) = mean(x̂ tx):
        # one reduce pass over (x, tx), one apply pass
        r3 = r[..., None]
        xhat = (x3.float() - mu[..., None]) * r3
        ty = (1.0 + scale.float()[:, None, :]) * _ln_tangent(xhat, r3, tx)
        if ts is not None:
            ty = ty + ts.float()[:, None, :] * xhat
        if tb is not None:
            ty = ty + tb.float()[:, None, :]
        return ty.to(x3.dtype)

    @staticmethod
    def backward(ctx, grad_y):
        return _vjp(ctx, _ln_film_ref, grad_y)


class _LnNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3):
        x3 = x3.contiguous()
        y, mu, r = stage_cuda.ln_norm_cuda(x3)
        ctx.save_for_backward(x3)
        ctx.save_for_forward(x3, mu, r)
        return y

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, tx):
        x3, mu, r = ctx.saved_tensors
        r3 = r[..., None]
        xhat = (x3.float() - mu[..., None]) * r3
        return _ln_tangent(xhat, r3, tx).to(x3.dtype)

    @staticmethod
    def backward(ctx, grad_y):
        return _vjp(ctx, _ln_norm_ref, grad_y)


def _ln_tangent(xhat: torch.Tensor, r3: torch.Tensor,
                tx: torch.Tensor) -> torch.Tensor:
    """Tangent of x̂ = (x - mean x) r along ``tx``, float32."""
    tx32 = tx.float()
    tmu = tx32.mean(dim=-1, keepdim=True)
    proj = (xhat * tx32).mean(dim=-1, keepdim=True)
    return r3 * (tx32 - tmu) - xhat * (r3 * proj)


class _GeluGrn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, gamma, beta):
        x3 = x3.contiguous()
        y, gx = stage_cuda.gelu_grn_cuda(x3, gamma, beta)
        ctx.save_for_backward(x3, gamma, beta)
        ctx.save_for_forward(x3, gamma, gx)
        return y

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, tx, tgamma, tbeta):
        x3, gamma, gx = ctx.saved_tensors
        x32 = x3.float()
        tx32 = tx.float()
        # g is recomputed elementwise; the statistic gx comes from the primal
        g = _gelu_f32(x32)
        tg = _gelu_grad_f32(x32) * tx32
        m = gx.mean(dim=-1, keepdim=True) + _GRN_MEAN_EPS
        nx = gx / m
        tgx = (g * tg).sum(dim=1) / gx
        tnx = (tgx - nx * tgx.mean(dim=-1, keepdim=True)) / m
        ty = tg * (gamma.float() + nx[:, None, :]) + g * tnx[:, None, :]
        if tgamma is not None:
            ty = ty + g * tgamma.float()
        if tbeta is not None:
            ty = ty + tbeta.float()
        return ty.to(x3.dtype)

    @staticmethod
    def backward(ctx, grad_y):
        return _vjp(ctx, _gelu_grn_ref, grad_y)


def fused_ln_film(x3: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """adaLN-norm + FiLM in one pass: ``normalize(x) * (1 + scale) + shift``.

    ``x3`` is [B, P, C] (P = flattened spatial positions); ``scale`` and
    ``shift`` are [B, C], broadcast over P. Statistics in float32; the
    result in ``x3``'s dtype.
    """
    return _LnFilm.apply(x3, scale, shift)


def fused_ln_norm(x3: torch.Tensor) -> torch.Tensor:
    """adaLN-norm (scale- and bias-free LayerNorm over C, float32 statistics)
    of [B, P, C] in one pass."""
    return _LnNorm.apply(x3)


def fused_gelu_grn(x3: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """tanh-GELU + ConvNeXt-V2 GRN of the pre-activation ``x3`` [B, P, C] in
    one pass, with the GRN parameters ``gamma``/``beta`` [C]; float32
    accumulation, the result in ``x3``'s dtype."""
    return _GeluGrn.apply(x3, gamma, beta)
