"""Small U-Net-style conditional conv flow; counterpart of
``meanflow_audio_codec_tpu/models/simple_conv_flow.py``.

down (2x2 average pool) x2 -> mid -> up (nearest resize) x2 on the flat
features laid out as a square ``[B, S, S, 1]`` grid, each stage a
FiLM-conditioned :class:`SimpleConvBlock`. A width that is not a square is
lifted by a Dense onto the next even square grid and unlifted at the end.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from meanflow_audio_codec_torch.models.blocks import Dense, SimpleConvBlock
from meanflow_audio_codec_torch.ops.embeddings import dual_time_embedding


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, no padding, on ``[B, H, W, C]`` (an odd
    side drops its last row or column, as Flax's ``avg_pool``)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _nearest_indices(size_in: int, size_out: int) -> np.ndarray:
    """Source index of each output pixel under ``jax.image.resize(...,
    "nearest")``: ``floor((i + 0.5) * in / out)`` in float32 (half-pixel
    centres; ``F.interpolate``'s "nearest" floors ``i * in / out``)."""
    offsets = ((np.arange(size_out, dtype=np.float32) + np.float32(0.5))
               * np.float32(size_in) / np.float32(size_out))
    return np.floor(offsets).astype(np.int64)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B, height, width, C]`` picking the pixels
    ``jax.image.resize(..., "nearest")`` picks."""
    rows = torch.from_numpy(_nearest_indices(x.shape[1], height)).to(x.device)
    cols = torch.from_numpy(_nearest_indices(x.shape[2], width)).to(x.device)
    return x[:, rows][:, :, cols]


class SimpleConvFlow(nn.Module):
    """U-Net-ish conditional flow over flat features: ``forward(x, time,
    latents)`` with ``time`` the ``[B, 2]`` (t, h) pair; ``encode`` is a
    linear probe ``[B, noise_dim] -> [B, latent_dim]``; ``latents=None``
    equals zero latents (``latent_proj`` has no bias)."""

    architecture = "simple_conv"  # its table in weights.py

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, latent_dimension: int,
                 base_channels: int = 32,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        del num_blocks  # the U-Net's depth is fixed, as in the JAX package
        self.noise_dimension = noise_dimension
        self.condition_dimension = condition_dimension
        self.latent_dimension = latent_dimension
        self.latent_shape = (latent_dimension,)
        self.compute_dtype = compute_dtype
        c, cond = base_channels, condition_dimension
        dt = dict(compute_dtype=compute_dtype)
        self.latent_proj = Dense(latent_dimension, cond, bias=False, **dt)
        self.encoder_head = Dense(noise_dimension, latent_dimension, **dt)
        self.down1 = SimpleConvBlock(1, c, cond, **dt)
        self.down2 = SimpleConvBlock(c, 2 * c, cond, **dt)
        self.mid = SimpleConvBlock(2 * c, 2 * c, cond, **dt)
        self.up2 = SimpleConvBlock(2 * c, 2 * c, cond, **dt)
        self.up1 = SimpleConvBlock(2 * c, c, cond, **dt)
        # 1x1 convs on the channels-last grid are Dense layers
        self.skip_proj = Dense(c, 2 * c, **dt)
        self.out_conv = Dense(c, 1, **dt)
        spatial = math.isqrt(noise_dimension)
        self.lift = self.unlift = None
        if spatial * spatial != noise_dimension:
            # a non-square width lifts to the nearest even square grid
            spatial = math.isqrt(noise_dimension - 1) + 1
            spatial += spatial % 2
            self.lift = Dense(noise_dimension, spatial * spatial, **dt)
            self.unlift = Dense(spatial * spatial, noise_dimension, **dt)
        self.spatial = spatial

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, noise_dim] -> [B, latent_dim]``."""
        return self.encoder_head(x.to(self.compute_dtype))

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                latents: torch.Tensor | None = None) -> torch.Tensor:
        batch = x.shape[0]
        cond = dual_time_embedding(time, self.condition_dimension).to(
            self.compute_dtype)
        if latents is not None:
            cond = cond + self.latent_proj(latents.reshape(batch, -1))
        h = x.to(self.compute_dtype)
        if self.lift is not None:
            h = self.lift(h)
        h = h.reshape(batch, self.spatial, self.spatial, 1)
        skip1 = self.down1(h, cond)
        skip2 = self.down2(_avg_pool(skip1), cond)
        h = self.mid(_avg_pool(skip2), cond)
        h = self.up2(resize_nearest(h, skip2.shape[1], skip2.shape[2])
                     + skip2, cond)
        h = resize_nearest(h, skip1.shape[1], skip1.shape[2])
        h = self.up1(h + self.skip_proj(skip1), cond)
        out = self.out_conv(h).reshape(batch, -1)
        if self.unlift is not None:
            out = self.unlift(out)
        return out
