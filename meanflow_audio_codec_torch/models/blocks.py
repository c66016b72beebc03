"""Building blocks of the ConvNeXt flow.

Counterpart of ``meanflow_audio_codec_tpu/models/blocks.py``. Precision
policy as in the JAX package: parameters stay float32 and each layer casts
its inputs and parameters to its compute dtype (bfloat16 under the codec's
"bfloat16"/"mixed" precision); normalisation statistics run in float32.

Activations keep the JAX package's channels-last layout, ``[B, H, W, C]``,
so every flatten and reshape reads features in the same order as the Flax
model. A 1x1 convolution on that layout is a :class:`Dense` over the last
axis; :class:`Conv2d` wraps the spatial convolutions.

The ``fused_stage`` branches (``FiLM(fuse_norm=True)``, GRN with
``fused_gelu=True``, ``ConvNeXtBlock(fused_stage=True)``) run the stage's
normalisation segments through the fused ops of ``ops/stage.py`` (hand-written
CUDA kernels on the card) with the same parameters as the plain branches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from meanflow_audio_codec_torch.ops.stage import (
    fused_gelu_grn,
    fused_ln_film,
    fused_ln_norm,
)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (Flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME": the extra pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """Square-kernel convolution on ``[B, H, W, C]`` with Flax "SAME" padding.

    A stride-2 3x3 conv on an even grid pads (0, 1), not torch's symmetric 1,
    so the padding is computed per input size and applied with ``F.pad``.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        k, s = self.kernel_size[0], self.stride[0]
        h_lo, h_hi = _same_padding(x.shape[1], k, s)
        w_lo, w_hi = _same_padding(x.shape[2], k, s)
        # NHWC storage viewed as NCHW is channels_last: no copy on the card
        h = F.pad(x.to(dt).permute(0, 3, 1, 2), (w_lo, w_hi, h_lo, h_hi))
        y = F.conv2d(h, self.weight.to(dt), self.bias.to(dt), stride=s)
        return y.permute(0, 2, 3, 1)


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, ..., C] -> [B, P, C]`` for the fused stage ops (a view of the
    channels-last activations)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def adaln_norm(x: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Scale- and bias-free LayerNorm over the last axis, float32 statistics,
    result cast back to the input dtype."""
    x32 = x.float()
    centered = x32 - x32.mean(dim=-1, keepdim=True)
    var = centered.square().mean(dim=-1, keepdim=True)
    return (centered * torch.rsqrt(var + epsilon)).to(x.dtype)


class GlobalResponseNormalization(nn.Module):
    """ConvNeXt-V2 GRN over ``[B, H, W, C]`` with float32 spatial norms.

    The 1e-12 sits inside the sqrt (the JAX package's NaN guard for channels
    that die to zero); gamma and beta are cast to the compute dtype before
    the product. ``fused_gelu=True`` takes the PRE-activation input and runs
    tanh-GELU + GRN as one fused op (float32 arithmetic, result in the input
    dtype).
    """

    def __init__(self, channels: int, epsilon: float = 1e-6,
                 fused_gelu: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.fused_gelu = fused_gelu
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_gelu:
            return fused_gelu_grn(_as_rows(x), self.gamma,
                                  self.beta).reshape(x.shape)
        spatial = tuple(range(1, x.ndim - 1))
        gx = torch.sqrt(x.float().square().sum(dim=spatial, keepdim=True)
                        + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + self.epsilon)
        return (x * (self.gamma.to(x.dtype) + nx.to(x.dtype))
                + self.beta.to(x.dtype))


class ConvNeXtBlock(nn.Module):
    """3x3 conv -> LN -> 1x1 expand -> GELU -> [GRN] -> 1x1 contract,
    layer-scaled, plus the residual (inference: no stochastic depth).

    The 3x3 conv is a full convolution (all input channels to each output
    channel), as in the JAX package. ``fused_stage=True`` runs the LN after
    the 3x3 conv and the GELU + GRN through the fused ops.
    """

    def __init__(self, dim: int, use_grn: bool = True,
                 layer_scale_init_value: float = 1e-6,
                 fused_stage: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fused_stage = fused_stage
        self.conv = Conv2d(dim, dim, 3, compute_dtype=compute_dtype)
        self.expand = Dense(dim, 2 * dim, compute_dtype=compute_dtype)
        self.grn = (GlobalResponseNormalization(2 * dim, fused_gelu=fused_stage)
                    if use_grn else None)
        self.contract = Dense(2 * dim, dim, compute_dtype=compute_dtype)
        self.layer_scale = (
            nn.Parameter(torch.full((dim,), layer_scale_init_value))
            if layer_scale_init_value > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if self.fused_stage:
            h = fused_ln_norm(_as_rows(h)).reshape(h.shape)
        else:
            h = adaln_norm(h)
        h = self.expand(h)
        if self.fused_stage and self.grn is not None:
            h = self.grn(h)  # the fused GRN applies the GELU itself
        else:
            h = gelu(h)
            if self.grn is not None:
                h = self.grn(h)
        h = self.contract(h)
        if self.layer_scale is not None:
            h = h * self.layer_scale.to(h.dtype)
        return h + x


class FiLM(nn.Module):
    """Feature-wise ``(1 + scale) * x + shift`` over the channel axis, with
    scale and shift projected from the condition vector.

    ``fuse_norm=True`` takes the PRE-norm input and runs the adaLN-norm and
    the modulation as one fused op.
    """

    def __init__(self, condition_dimension: int, channels: int,
                 fuse_norm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fuse_norm = fuse_norm
        self.proj = Dense(condition_dimension, 2 * channels,
                          compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        scale, shift = self.proj(condition).chunk(2, dim=-1)
        if self.fuse_norm:
            return fused_ln_film(_as_rows(x), scale, shift).reshape(x.shape)
        expand = (slice(None),) + (None,) * (x.ndim - 2)
        return (1.0 + scale[expand]) * x + shift[expand]
