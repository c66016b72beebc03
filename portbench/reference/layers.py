"""The plain float32 pieces every model family's reference is built from:
the products (``Ops``, and ``FP8Ops`` for the comparison's control), the
tanh GELU, the scale-free LayerNorm and the time embedding.

``Ops`` computes every product in float32 with TF32 off; ``FP8Ops`` rounds
both operands of every product to float8 e4m3 (per-tensor scale) first, the
precision below the codec's bfloat16, which serves as the comparison's
control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Ops:
    """Products in float32."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b, stride):
        """Channels-last SAME convolution of a square kernel."""
        k = w.shape[-1]
        pads = []
        for size in (x.shape[2], x.shape[1]):  # F.pad wants W first
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        h = F.pad(x.permute(0, 3, 1, 2), pads)
        return F.conv2d(self.q(h), self.q(w), b, stride=stride).permute(0, 2, 3, 1)


class FP8Ops(Ops):
    """Products of float8 e4m3 operands (per-tensor absmax scale), in
    float32 otherwise; the rounding passes gradients and tangents straight
    through."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())


def gelu(x):
    return F.gelu(x, approximate="tanh")


def layer_norm(x, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def embedding(x, dim: int):
    """The [cos, sin] sinusoid of 10000-period frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    args = x[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
