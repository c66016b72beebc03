"""ConvNeXt conditional flow and its conv encoder.

Counterpart of ``meanflow_audio_codec_tpu/models/conv_flow.py``: each
decoder stage lifts the flat features through a Dense bottleneck onto an
``[B, S, S, C]`` grid, FiLM-modulates it on the condition, runs a ConvNeXt
block and projects back with a 1/num_blocks residual. Latents enter through
the condition vector. ``remat`` recomputes each stage's activations in the
backward pass: the elementwise segments only under ``dots_saveable``, the
whole stage under policy None (``models/remat.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from meanflow_audio_codec_torch.models.blocks import (
    Conv2d,
    ConvNeXtBlock,
    Dense,
    FiLM,
    adaln_norm,
    gelu,
)
from meanflow_audio_codec_torch.models.remat import (
    SEGMENT_POLICIES,
    check_policy,
    remat,
)
from meanflow_audio_codec_torch.ops.embeddings import dual_time_embedding


class ConvStage(nn.Module):
    """One decoder layer: Dense bottleneck -> grid -> LN + FiLM -> ConvNeXt
    block -> Dense back.

    ``spatial`` is the grid side (default isqrt(noise_dimension));
    ``lift_channels`` c0 factorises the lift into a thin [S, S, c0] Dense
    output and a 1x1 conv c0 -> C (default: Dense straight to C channels).
    ``fused_stage`` runs the LN + FiLM and the block's normalisation segments
    through the fused stage ops (``ops/stage.py``). ``remat_segments``
    recomputes the LN + FiLM and the block's elementwise segments in the
    backward pass and keeps the products' outputs (``dots_saveable``; the
    FiLM's small condition projection, [B, 2C], is recomputed with its
    segment). ``quantized`` serves the four Dense layers and the five
    convolutions (the 1x1 lift, the block's three, the 1x1 back) in W8A8
    int8; FiLM's projection stays in the compute dtype, as in the JAX
    package.
    """

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, use_grn: bool = True,
                 bottleneck_dim: int = 128, channels: int | None = None,
                 spatial: int | None = None, lift_channels: int | None = None,
                 fused_stage: bool = False, remat_segments: bool = False,
                 quantized: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        self.remat_segments = remat_segments
        self.spatial = (spatial if spatial is not None
                        else math.isqrt(noise_dimension))
        channels = (channels if channels is not None
                    else min(16, condition_dimension // 4))
        grid_channels = lift_channels if lift_channels is not None else channels
        self.grid_channels = grid_channels
        dt = dict(compute_dtype=compute_dtype)
        q = dict(dt, quantized=quantized)
        self.bottleneck_in = Dense(noise_dimension, bottleneck_dim, **q)
        self.lift = Dense(bottleneck_dim,
                          self.spatial * self.spatial * grid_channels, **q)
        # 1x1 convs on the channels-last grid are Dense layers
        self.lift_conv = (Dense(lift_channels, channels, **q)
                          if lift_channels is not None else None)
        self.fused_stage = fused_stage
        self.film = FiLM(condition_dimension, channels, fuse_norm=fused_stage,
                         **dt)
        self.block = ConvNeXtBlock(channels, use_grn=use_grn,
                                   fused_stage=fused_stage,
                                   remat_segments=remat_segments, **q)
        self.unlift_conv = (Dense(channels, lift_channels, **q)
                            if lift_channels is not None else None)
        self.bottleneck_out = Dense(
            self.spatial * self.spatial * grid_channels, bottleneck_dim, **q)
        self.out = Dense(bottleneck_dim, noise_dimension, **q)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = gelu(self.bottleneck_in(x))
        h = self.lift(h).reshape(x.shape[0], self.spatial, self.spatial,
                                 self.grid_channels)
        if self.lift_conv is not None:
            h = self.lift_conv(h)
        segment = remat if self.remat_segments else (lambda fn, *a: fn(*a))
        h = segment(self._norm_film, h, condition)
        h = self.block(h)
        if self.unlift_conv is not None:
            h = self.unlift_conv(h)
        h = gelu(self.bottleneck_out(h.reshape(x.shape[0], -1)))
        return self.out(h) / self.num_blocks + x

    def _norm_film(self, h: torch.Tensor,
                   condition: torch.Tensor) -> torch.Tensor:
        if not self.fused_stage:  # the fused FiLM normalises itself
            h = adaln_norm(h)
        return self.film(h, condition)


class ConvEncoder(nn.Module):
    """``[B, noise_dim] -> [B, latent_dim]``: two stride-2 conv + LN + GELU
    stages on a square grid, then a Dense head. A non-square width is lifted
    to the next square grid by a Dense first."""

    def __init__(self, noise_dimension: int, latent_dimension: int,
                 base_channels: int = 16,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        dt = dict(compute_dtype=compute_dtype)
        spatial = math.isqrt(noise_dimension)
        self.lift = None
        if spatial * spatial != noise_dimension:
            spatial = math.isqrt(noise_dimension - 1) + 1
            self.lift = Dense(noise_dimension, spatial * spatial, **dt)
        self.spatial = spatial
        self.convs = nn.ModuleList([
            Conv2d(1, base_channels, 3, stride=2, **dt),
            Conv2d(base_channels, 2 * base_channels, 3, stride=2, **dt),
        ])
        side = -(-spatial // 4)  # two SAME stride-2 convs: ceil(ceil(S/2)/2)
        self.head = Dense(side * side * 2 * base_channels, latent_dimension,
                          **dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.compute_dtype)
        if self.lift is not None:
            h = self.lift(h)
        h = h.reshape(x.shape[0], self.spatial, self.spatial, 1)
        for conv in self.convs:
            h = gelu(adaln_norm(conv(h)))
        return self.head(h.reshape(x.shape[0], -1))


class ConditionalConvFlow(nn.Module):
    """Conditional flow with ConvNeXt decoder stages and an integrated encoder.

    ``forward(x, time, latents)`` with ``time`` the ``[B, 2]`` (t, h) pair;
    ``latents=None`` equals zero latents (``latent_proj`` has no bias).
    ``fused_stage`` goes to every decoder stage; the encoder has no fused
    path. ``remat`` recomputes each decoder stage in the backward pass, as
    the JAX package's ``nn.remat(ConvStage, policy=...)``: under
    ``dots_saveable`` / ``checkpoint_dots`` each stage checkpoints its
    elementwise segments and keeps the products' outputs, under policy None
    / ``nothing_saveable`` the stage is recomputed whole
    (``models/remat.py``). ``quantized`` serves every decoder stage's
    products in W8A8 int8 (:class:`ConvStage`); the encoder, ``latent_proj``
    and the conditioning stay in the compute dtype, as in the JAX package.
    ``image_size`` and ``num_latent_tokens`` are kept, in the JAX model's
    places, and nothing reads them, as there.
    """

    architecture = "convnet"  # its table in weights.py

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, latent_dimension: int, image_size: int = 28,
                 use_grn: bool = True, num_latent_tokens: int = 32,
                 channels: int | None = None, bottleneck_dim: int = 128,
                 spatial: int | None = None, lift_channels: int | None = None,
                 fused_stage: bool = False, remat: bool = False,
                 remat_policy: str | None = None, quantized: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_policy(remat_policy)
        self.noise_dimension = noise_dimension
        self.condition_dimension = condition_dimension
        self.latent_dimension = latent_dimension
        self.latent_shape = (latent_dimension,)
        self.image_size = image_size
        self.num_latent_tokens = num_latent_tokens
        self.remat = remat
        self.remat_policy = remat_policy
        segments = remat and remat_policy in SEGMENT_POLICIES
        self.remat_stages = remat and not segments
        self.compute_dtype = compute_dtype
        self.stages = nn.ModuleList([
            ConvStage(noise_dimension, condition_dimension, num_blocks,
                      use_grn=use_grn, bottleneck_dim=bottleneck_dim,
                      channels=channels, spatial=spatial,
                      lift_channels=lift_channels, fused_stage=fused_stage,
                      remat_segments=segments, quantized=quantized,
                      compute_dtype=compute_dtype)
            for _ in range(num_blocks)
        ])
        self.latent_proj = Dense(latent_dimension, condition_dimension,
                                 bias=False, compute_dtype=compute_dtype)
        self.encoder = ConvEncoder(noise_dimension, latent_dimension,
                                   compute_dtype=compute_dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, noise_dim] -> [B, latent_dim]``."""
        return self.encoder(x)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                latents: torch.Tensor | None = None) -> torch.Tensor:
        cond = dual_time_embedding(time, self.condition_dimension).to(
            self.compute_dtype)
        if latents is not None:
            cond = cond + self.latent_proj(latents.reshape(latents.shape[0], -1))
        h = x.to(self.compute_dtype)
        for stage in self.stages:
            h = remat(stage, h, cond) if self.remat_stages else stage(h, cond)
        return h
