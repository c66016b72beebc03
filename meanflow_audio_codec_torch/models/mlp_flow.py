"""MLP encoder-decoder flow; counterpart of
``meanflow_audio_codec_tpu/models/mlp_flow.py``.

``ConditionalFlow`` compresses flat features to a latent and decodes noise
conditioned on (latent, t, h) through a stack of adaLN residual blocks, the
latent concatenated before every block. ``latents=None`` runs the
zero-latent (classifier-free guidance) path.
"""

from __future__ import annotations

import torch
from torch import nn

from meanflow_audio_codec_torch.models.blocks import (
    MLP,
    ConditionalResidualBlock,
)
from meanflow_audio_codec_torch.ops.embeddings import dual_time_embedding


class MLPEncoder(nn.Module):
    """``[B, input_dim] -> [B, latent_dim]`` through one MLP whose hidden
    width is ``(input_dim + latent_dim) // 2``."""

    def __init__(self, input_dimension: int, latent_dimension: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = (input_dimension + latent_dimension) // 2
        self.mlp = MLP(input_dimension, hidden, latent_dimension,
                       compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class ConditionalFlow(nn.Module):
    """Autoencoder flow over flat features: ``forward(x, time, latents)``
    with ``time`` the ``[B, 2]`` (t, h) pair, and ``encode(x)``."""

    architecture = "mlp"  # its table in weights.py

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, latent_dimension: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.noise_dimension = noise_dimension
        self.condition_dimension = condition_dimension
        self.latent_dimension = latent_dimension
        self.latent_shape = (latent_dimension,)
        self.compute_dtype = compute_dtype
        self.encoder = MLPEncoder(noise_dimension, latent_dimension,
                                  compute_dtype=compute_dtype)
        self.blocks = nn.ModuleList([
            ConditionalResidualBlock(latent_dimension + noise_dimension,
                                     noise_dimension, condition_dimension,
                                     num_blocks, compute_dtype=compute_dtype)
            for _ in range(num_blocks)])

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, noise_dim] -> [B, latent_dim]``."""
        return self.encoder(x.to(self.compute_dtype))

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                latents: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        if latents is None:
            latents = x.new_zeros((x.shape[0], self.latent_dimension),
                                  dtype=dt)
        cond = dual_time_embedding(time, self.condition_dimension).to(dt)
        h, latents = x.to(dt), latents.to(dt)
        for block in self.blocks:
            h = block(torch.cat([latents, h], dim=-1), cond)
        return h
