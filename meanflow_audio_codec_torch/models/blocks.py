"""Building blocks of every model family.

Counterpart of ``meanflow_audio_codec_tpu/models/blocks.py`` (and of
``SimpleConvBlock`` in ``simple_conv_flow.py``). Precision
policy as in the JAX package: parameters stay float32 and each layer casts
its inputs and parameters to its compute dtype (bfloat16 under the codec's
"bfloat16"/"mixed" precision); normalisation statistics run in float32.

Activations keep the JAX package's channels-last layout, ``[B, H, W, C]``,
so every flatten and reshape reads features in the same order as the Flax
model. A 1x1 convolution on that layout is a :class:`Dense` over the last
axis; :class:`Conv2d` wraps the spatial convolutions.

The fused branches (:meth:`FiLM.norm_modulate`,
:meth:`GlobalResponseNormalization.gelu_grn`, the LN of
:class:`ConvNeXtBlock`) run the stage's normalisation segments through the
fused ops of ``ops/stage.py`` (hand-written CUDA kernels on the card) with
the same parameters as the plain branches. The ConvNeXt stage takes them on
the card whenever nothing differentiates the forward
(``ops.stage.inference_on_card``), and everywhere with ``fused_stage=True``;
``FiLM(fuse_norm=True)`` and GRN with ``fused_gelu=True`` always take them.
``quantized=True`` on :class:`Dense`, :class:`Conv2d` and
:class:`ConvNeXtBlock` serves their products in dynamic W8A8 int8
(``ops/quant.py``, the JAX package's ``quant_injection``), with the same
parameters, so a bf16 checkpoint loads unchanged.

Each :class:`Dense` and :class:`Conv2d` call is a ``product`` span
(``tracing``): its operand casts, padding, product and bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from meanflow_audio_codec_torch import tracing
from meanflow_audio_codec_torch.models.remat import remat
from meanflow_audio_codec_torch.ops.quant import int8_conv2d, int8_linear
from meanflow_audio_codec_torch.ops.stage import (
    fused_gelu_grn,
    fused_ln_film,
    fused_ln_norm,
    inference_on_card,
)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (Flax ``Dense(dtype=...)``);
    in W8A8 int8 when ``quantized``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 quantized: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.quantized = quantized

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tracing.ON:  # a test of the flag alone on the hot path when off
            with tracing.span("product"):
                return self._product(x)
        return self._product(x)

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.quantized:
            return int8_linear(x.to(dt), self.weight.to(dt), bias)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME": the extra pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """Square-kernel convolution on ``[B, H, W, C]`` with Flax "SAME" padding.

    A stride-2 3x3 conv on an even grid pads (0, 1), not torch's symmetric 1,
    so the padding is computed per input size and applied with ``F.pad``
    (or by the int8 im2col when ``quantized``).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, compute_dtype: torch.dtype = torch.float32,
                 quantized: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0)
        self.compute_dtype = compute_dtype
        self.quantized = quantized

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tracing.ON:  # as Dense.forward
            with tracing.span("product"):
                return self._product(x)
        return self._product(x)

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        k, s = self.kernel_size[0], self.stride[0]
        h_lo, h_hi = _same_padding(x.shape[1], k, s)
        w_lo, w_hi = _same_padding(x.shape[2], k, s)
        if self.quantized:
            return int8_conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                               stride=s, padding=((h_lo, h_hi), (w_lo, w_hi)))
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
    """Scale- and bias-free LayerNorm over the last axis, float32 statistics
    (the mean of a bfloat16 input is taken in float32, as the JAX package's
    ``_adaln_norm``), result cast back to the input dtype."""
    x32 = x.float()
    centered = x32 - x32.mean(dim=-1, keepdim=True)
    var = centered.square().mean(dim=-1, keepdim=True)
    return (centered * torch.rsqrt(var + epsilon)).to(x.dtype)


class GlobalResponseNormalization(nn.Module):
    """ConvNeXt-V2 GRN over ``[B, H, W, C]`` with float32 spatial norms.

    The 1e-12 sits inside the sqrt (the JAX package's NaN guard for channels
    that die to zero); gamma and beta are cast to the compute dtype before
    the product. :meth:`gelu_grn` takes the PRE-activation input and runs
    tanh-GELU + GRN as one fused op (float32 arithmetic, result in the input
    dtype); ``fused_gelu=True`` makes it the module's call. The ConvNeXt
    block calls it on the card whenever nothing differentiates the forward,
    and ``fused_stage`` decides only the differentiated calls.
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
            return self.gelu_grn(x)
        spatial = tuple(range(1, x.ndim - 1))
        gx = torch.sqrt(x.float().square().sum(dim=spatial, keepdim=True)
                        + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + self.epsilon)
        return (x * (self.gamma.to(x.dtype) + nx.to(x.dtype))
                + self.beta.to(x.dtype))

    def gelu_grn(self, x: torch.Tensor) -> torch.Tensor:
        """tanh-GELU + GRN of the pre-activation ``x`` as one fused op."""
        return fused_gelu_grn(_as_rows(x), self.gamma,
                              self.beta).reshape(x.shape)


class ConvNeXtBlock(nn.Module):
    """3x3 conv -> LN -> 1x1 expand -> GELU -> [GRN] -> 1x1 contract,
    layer-scaled, with optional stochastic depth, plus the residual.

    The 3x3 conv is a full convolution (all input channels to each output
    channel), as in the JAX package. With ``drop_path`` p > 0 and
    ``train=True`` each example keeps its branch with probability 1 - p,
    scaled by 1 / (1 - p): ``keep`` (``[B]``, 0 or 1) gives the mask, or it
    is drawn by ``torch.bernoulli`` from ``generator`` on the input's device
    (the JAX block draws it from its ``"drop_path"`` rng).
    The LN after the 3x3 conv and the GELU + GRN run through the fused ops
    on the card whenever nothing differentiates the forward
    (``ops.stage.inference_on_card``: no autograd recording, no dual level
    open, float32 or bfloat16 activations); ``fused_stage=True`` runs them
    so on the differentiated paths too.
    ``remat_segments=True`` recomputes the LN and the GELU + GRN in the
    backward pass and keeps the products' outputs (``models/remat.py``).
    ``quantized=True`` serves the three convs in W8A8 int8.
    """

    def __init__(self, dim: int, drop_path: float = 0.0,
                 use_grn: bool = True, layer_scale_init_value: float = 1e-6,
                 fused_stage: bool = False, remat_segments: bool = False,
                 quantized: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path = drop_path
        self.fused_stage = fused_stage
        self.remat_segments = remat_segments
        q = dict(compute_dtype=compute_dtype, quantized=quantized)
        self.conv = Conv2d(dim, dim, 3, **q)
        self.expand = Dense(dim, 2 * dim, **q)
        self.grn = GlobalResponseNormalization(2 * dim) if use_grn else None
        self.contract = Dense(2 * dim, dim, **q)
        self.layer_scale = (
            nn.Parameter(torch.full((dim,), layer_scale_init_value))
            if layer_scale_init_value > 0 else None)

    def _norm(self, h: torch.Tensor) -> torch.Tensor:
        if self.fused_stage or inference_on_card(h):
            return fused_ln_norm(_as_rows(h)).reshape(h.shape)
        return adaln_norm(h)

    def _activation(self, h: torch.Tensor) -> torch.Tensor:
        if self.grn is not None and (self.fused_stage
                                     or inference_on_card(h)):
            return self.grn.gelu_grn(h)
        h = gelu(h)
        return self.grn(h) if self.grn is not None else h

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        segment = remat if self.remat_segments else (lambda fn, *a: fn(*a))
        h = segment(self._norm, self.conv(x))
        h = segment(self._activation, self.expand(h))
        h = self.contract(h)
        if self.layer_scale is not None:
            h = h * self.layer_scale.to(h.dtype)
        if self.drop_path > 0.0 and train:
            keep_prob = 1.0 - self.drop_path
            if keep is None:
                keep = torch.bernoulli(
                    torch.full((h.shape[0],), keep_prob, device=h.device),
                    generator=generator)
            mask = keep.reshape((-1,) + (1,) * (h.ndim - 1)).to(h.dtype)
            h = h * mask / keep_prob
        return h + x


class FiLM(nn.Module):
    """Feature-wise ``(1 + scale) * x + shift`` over the channel axis, with
    scale and shift projected from the condition vector.

    :meth:`norm_modulate` takes the PRE-norm input and runs the adaLN-norm
    and the modulation as one fused op; ``fuse_norm=True`` makes it the
    module's call. The ConvNeXt stage calls it on the card whenever nothing
    differentiates the forward, and ``fused_stage`` decides only the
    differentiated calls.
    """

    def __init__(self, condition_dimension: int, channels: int,
                 fuse_norm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fuse_norm = fuse_norm
        self.proj = Dense(condition_dimension, 2 * channels,
                          compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        if self.fuse_norm:
            return self.norm_modulate(x, condition)
        scale, shift = self.proj(condition).chunk(2, dim=-1)
        expand = (slice(None),) + (None,) * (x.ndim - 2)
        return (1.0 + scale[expand]) * x + shift[expand]

    def norm_modulate(self, x: torch.Tensor,
                      condition: torch.Tensor) -> torch.Tensor:
        """adaLN-norm + FiLM of the pre-norm ``x`` as one fused op."""
        scale, shift = self.proj(condition).chunk(2, dim=-1)
        return fused_ln_film(_as_rows(x), scale, shift).reshape(x.shape)


class MLP(nn.Module):
    """Dense -> tanh-GELU -> Dense."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, compute_dtype=compute_dtype)
        self.fc2 = Dense(hidden, out, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class ConditionalResidualBlock(nn.Module):
    """adaLN residual block over flat ``[latent ++ noise]`` features: the
    conditioning MLP emits (scale1, shift, scale2), the residual comes from
    the noise slice only and the block output is scaled by 1/num_blocks."""

    def __init__(self, input_dimension: int, noise_dimension: int,
                 condition_dimension: int, num_blocks: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dimension = input_dimension
        self.noise_dimension = noise_dimension
        self.num_blocks = num_blocks
        dt = dict(compute_dtype=compute_dtype)
        self.modulation = MLP(condition_dimension, condition_dimension,
                              2 * input_dimension + noise_dimension, **dt)
        self.mlp = MLP(input_dimension, input_dimension, noise_dimension, **dt)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        residual = x[:, -self.noise_dimension:]
        d = self.input_dimension
        scale1, shift, scale2 = self.modulation(condition).split(
            (d, d, self.noise_dimension), dim=-1)
        h = self.mlp((1.0 + scale1) * adaln_norm(x) + shift)
        return h * (1.0 + scale2) / self.num_blocks + residual


class MixerBlock(nn.Module):
    """MLP-Mixer block on ``[B, tokens, channels]``: adaLN -> token mix (over
    the swapped axis) -> residual -> adaLN -> channel mix -> residual."""

    def __init__(self, token_mix_dim: int, channel_mix_dim: int,
                 num_channels: int, num_tokens: int, condition_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.token_modulation = Dense(condition_dim, 2 * num_channels, **dt)
        self.token_mix = MLP(num_tokens, token_mix_dim, num_tokens, **dt)
        self.channel_modulation = Dense(condition_dim, 2 * num_channels, **dt)
        self.channel_mix = MLP(num_channels, channel_mix_dim, num_channels,
                               **dt)

    @staticmethod
    def _modulate(x: torch.Tensor, condition: torch.Tensor,
                  proj: Dense) -> torch.Tensor:
        scale, shift = proj(condition).chunk(2, dim=-1)
        return (1.0 + scale[:, None, :]) * adaln_norm(x) + shift[:, None, :]

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = self._modulate(x, condition, self.token_modulation)
        x = x + self.token_mix(h.transpose(-1, -2)).transpose(-1, -2)
        h = self._modulate(x, condition, self.channel_modulation)
        return x + self.channel_mix(h)


class SimpleConvBlock(nn.Module):
    """3x3 conv -> LN -> FiLM -> GELU -> 3x3 conv, plus the residual (through
    a 1x1 conv when the channel count changes)."""

    def __init__(self, in_channels: int, channels: int,
                 condition_dimension: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.conv1 = Conv2d(in_channels, channels, 3, **dt)
        self.film = FiLM(condition_dimension, channels, **dt)
        self.conv2 = Conv2d(channels, channels, 3, **dt)
        self.residual_proj = (Dense(in_channels, channels, **dt)
                              if in_channels != channels else None)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = gelu(self.film(adaln_norm(self.conv1(x)), condition))
        h = self.conv2(h)
        residual = (self.residual_proj(x) if self.residual_proj is not None
                    else x)
        return h + residual
