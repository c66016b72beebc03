"""Plain PyTorch versions of the ConvNeXt stage's three normalisation
segments, and the tanh-GELU they share.

Counterpart of the jnp references in
``meanflow_audio_codec_tpu/ops/stage_pallas.py``. Each computes its segment
and the statistics the fused op keeps in float32, with the same constants
(LayerNorm eps 1e-6; GRN eps 1e-12 inside the sqrt, 1e-6 on the mean).
``ops/stage_cuda.py`` runs them on CPU tensors; ``ops/stage.py`` uses them for
the ops' backward and tangents.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LN_EPS = 1e-6
_GRN_SQ_EPS = 1e-12
_GRN_MEAN_EPS = 1e-6


# No plain version calls MKL's vector math (ROADMAP §3): on the CPU
# ``torch.tanh`` is MKL's ``vsTanh``, which once returned one internal
# thread's 2048-element chunk at its reduced-accuracy (EP) level, about 5e-5
# off in tanh, and ``torch.sqrt`` is ``vsSqrt``, whose last bit depends on
# MKL's code path. Both GELU functions run ATen's own gelu kernels (SLEEF's
# tanhf, 1 ulp), and GRN's square root is taken in float64 and rounded once
# to float32.


def _gelu_f32(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, as ``jax.nn.gelu(approximate=True)``:
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))``."""
    return F.gelu(x, approximate="tanh")


def _gelu_grad_f32(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-approximate GELU."""
    return torch.ops.aten.gelu_backward(torch.ones_like(x), x,
                                        approximate="tanh")


def _ln_stats_f32(x3: torch.Tensor):
    """(x̂, mu, r) of a bias-free LayerNorm over the last axis, two-pass
    variance, all float32."""
    x32 = x3.float()
    mu = x32.mean(dim=-1, keepdim=True)
    d = x32 - mu
    r = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + _LN_EPS)
    return d * r, mu[..., 0], r[..., 0]


def _ln_film_ref(x3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """[B,P,C], [B,C], [B,C] -> (y [B,P,C] in x's dtype, mu [B,P], r [B,P])."""
    xhat, mu, r = _ln_stats_f32(x3)
    y = (1.0 + scale.float()[:, None, :]) * xhat + shift.float()[:, None, :]
    return y.to(x3.dtype), mu, r


def _ln_norm_ref(x3: torch.Tensor):
    """[B,P,C] -> (y in x's dtype, mu [B,P], r [B,P])."""
    xhat, mu, r = _ln_stats_f32(x3)
    return xhat.to(x3.dtype), mu, r


def _gelu_grn_ref(x3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """[B,P,C], [C], [C] -> (y [B,P,C] in x's dtype, gx [B,C])."""
    g = _gelu_f32(x3.float())
    gx = ((g * g).sum(dim=1) + _GRN_SQ_EPS).double().sqrt().float()
    m = gx.mean(dim=-1, keepdim=True) + _GRN_MEAN_EPS
    y = g * (gamma.float() + (gx / m)[:, None, :]) + beta.float()
    return y.to(x3.dtype), gx
