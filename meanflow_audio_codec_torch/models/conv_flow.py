"""ConvNeXt conditional flow and its conv encoder.

Counterpart of ``meanflow_audio_codec_tpu/models/conv_flow.py``: each
decoder stage lifts the flat features through a Dense bottleneck onto an
``[B, S, S, C]`` grid, FiLM-modulates it on the condition, runs a ConvNeXt
block and projects back with a 1/num_blocks residual. Latents enter through
the condition vector.
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
from meanflow_audio_codec_torch.ops.embeddings import dual_time_embedding


class ConvStage(nn.Module):
    """One decoder layer: Dense bottleneck -> grid -> LN + FiLM -> ConvNeXt
    block -> Dense back.

    ``spatial`` is the grid side (default isqrt(noise_dimension));
    ``lift_channels`` c0 factorises the lift into a thin [S, S, c0] Dense
    output and a 1x1 conv c0 -> C (default: Dense straight to C channels).
    ``fused_stage`` runs the LN + FiLM and the block's normalisation segments
    through the fused stage ops (``ops/stage.py``).
    """

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, use_grn: bool = True,
                 bottleneck_dim: int = 128, channels: int | None = None,
                 spatial: int | None = None, lift_channels: int | None = None,
                 fused_stage: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        self.spatial = (spatial if spatial is not None
                        else math.isqrt(noise_dimension))
        channels = (channels if channels is not None
                    else min(16, condition_dimension // 4))
        grid_channels = lift_channels if lift_channels is not None else channels
        self.grid_channels = grid_channels
        dt = dict(compute_dtype=compute_dtype)
        self.bottleneck_in = Dense(noise_dimension, bottleneck_dim, **dt)
        self.lift = Dense(bottleneck_dim,
                          self.spatial * self.spatial * grid_channels, **dt)
        # 1x1 convs on the channels-last grid are Dense layers
        self.lift_conv = (Dense(lift_channels, channels, **dt)
                          if lift_channels is not None else None)
        self.fused_stage = fused_stage
        self.film = FiLM(condition_dimension, channels, fuse_norm=fused_stage,
                         **dt)
        self.block = ConvNeXtBlock(channels, use_grn=use_grn,
                                   fused_stage=fused_stage, **dt)
        self.unlift_conv = (Dense(channels, lift_channels, **dt)
                            if lift_channels is not None else None)
        self.bottleneck_out = Dense(
            self.spatial * self.spatial * grid_channels, bottleneck_dim, **dt)
        self.out = Dense(bottleneck_dim, noise_dimension, **dt)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = gelu(self.bottleneck_in(x))
        h = self.lift(h).reshape(x.shape[0], self.spatial, self.spatial,
                                 self.grid_channels)
        if self.lift_conv is not None:
            h = self.lift_conv(h)
        if not self.fused_stage:
            h = adaln_norm(h)
        h = self.film(h, condition)  # the fused FiLM normalises itself
        h = self.block(h)
        if self.unlift_conv is not None:
            h = self.unlift_conv(h)
        h = gelu(self.bottleneck_out(h.reshape(x.shape[0], -1)))
        return self.out(h) / self.num_blocks + x


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
    path.
    """

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, latent_dimension: int, use_grn: bool = True,
                 channels: int | None = None, bottleneck_dim: int = 128,
                 spatial: int | None = None, lift_channels: int | None = None,
                 fused_stage: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.noise_dimension = noise_dimension
        self.condition_dimension = condition_dimension
        self.compute_dtype = compute_dtype
        self.stages = nn.ModuleList([
            ConvStage(noise_dimension, condition_dimension, num_blocks,
                      use_grn=use_grn, bottleneck_dim=bottleneck_dim,
                      channels=channels, spatial=spatial,
                      lift_channels=lift_channels, fused_stage=fused_stage,
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
            h = stage(h, cond)
        return h
