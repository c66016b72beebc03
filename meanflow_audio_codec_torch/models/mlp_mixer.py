"""MLP-Mixer flow and autoencoder family; counterpart of
``meanflow_audio_codec_tpu/models/mlp_mixer.py``.

``ConditionalMLPMixerFlow`` lifts flat features onto a token grid, runs one
adaLN mixer block per decoder stage and projects back with a 1/num_blocks
residual; the latent tokens enter through the condition vector. Its
``encode`` is a query-token ``MLPMixerEncoder`` giving ``[B,
num_latent_tokens, latent_dim]`` tokens. ``MLPMixerDecoder`` and
``MLPMixerAutoencoder`` complete the family.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from meanflow_audio_codec_torch.models.blocks import Dense, MixerBlock
from meanflow_audio_codec_torch.ops.embeddings import dual_time_embedding

#: parameters drawn from a normal of this standard deviation at init
QUERY_INIT_STD = 0.02


class MixerStage(nn.Module):
    """One decoder stage: flat -> token grid -> mixer block -> flat, residual
    / num_blocks.

    The reference lift is ``Dense(noise_dim -> tokens * channels)`` with
    ``tokens = isqrt(noise_dim)**2`` (quadratic in the flat width);
    ``factorized=True`` reshapes the flat feature into ``num_tokens`` tokens
    of width ``noise_dim / tokens`` and lifts each with one shared Dense.
    """

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, token_mix_dim: int = 2048,
                 channel_mix_dim: int = 2048, num_channels: int = 16,
                 num_tokens: int | None = None, factorized: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_tokens is None:
            num_tokens = math.isqrt(noise_dimension) ** 2
        self.num_blocks = num_blocks
        self.num_tokens = num_tokens
        self.num_channels = num_channels
        self.factorized = factorized
        dt = dict(compute_dtype=compute_dtype)
        if factorized:
            if noise_dimension % num_tokens:
                raise ValueError(
                    f"factorized MixerStage needs num_tokens ({num_tokens}) "
                    f"dividing noise_dimension ({noise_dimension})")
            self.width = noise_dimension // num_tokens
            self.lift = Dense(self.width, num_channels, **dt)
            self.out = Dense(num_channels, self.width, **dt)
        else:
            self.lift = Dense(noise_dimension, num_tokens * num_channels, **dt)
            self.out = Dense(num_tokens * num_channels, noise_dimension, **dt)
        self.block = MixerBlock(token_mix_dim, channel_mix_dim, num_channels,
                                num_tokens, condition_dimension, **dt)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        batch = x.shape[0]
        if self.factorized:
            h = self.lift(x.reshape(batch, self.num_tokens, self.width))
        else:
            h = self.lift(x).reshape(batch, self.num_tokens, self.num_channels)
        h = self.block(h, condition)
        if self.factorized:
            h = self.out(h).reshape(batch, -1)
        else:
            h = self.out(h.reshape(batch, -1))
        return h / self.num_blocks + x


def _expand(queries: torch.Tensor, condition_emb: torch.Tensor, batch: int,
            dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Learned query tokens ``[n, C]`` and condition ``[C]`` broadcast over
    the batch, in the compute dtype."""
    return (queries.to(dtype)[None].expand(batch, -1, -1),
            condition_emb.to(dtype)[None].expand(batch, -1))


class MLPMixerEncoder(nn.Module):
    """Query-token encoder: context tokens ++ learned latent queries through
    one mixer block; the query rows become the latent."""

    normal_init = ("latent_queries", "condition_emb")

    def __init__(self, input_dim: int, num_latent_tokens: int = 32,
                 latent_dim: int = 512, num_context_tokens: int = 512,
                 token_mix_dim: int = 2048, channel_mix_dim: int = 2048,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_context_tokens = num_context_tokens
        self.latent_dim = latent_dim
        self.compute_dtype = compute_dtype
        self.context = Dense(input_dim, num_context_tokens * latent_dim,
                             compute_dtype=compute_dtype)
        self.latent_queries = nn.Parameter(
            torch.zeros(num_latent_tokens, latent_dim))
        self.condition_emb = nn.Parameter(torch.zeros(latent_dim))
        self.block = MixerBlock(token_mix_dim, channel_mix_dim, latent_dim,
                                num_context_tokens + num_latent_tokens,
                                latent_dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[0]
        context = self.context(x).reshape(batch, self.num_context_tokens,
                                          self.latent_dim)
        queries, condition = _expand(self.latent_queries, self.condition_emb,
                                     batch, self.compute_dtype)
        tokens = self.block(torch.cat([context, queries], dim=1), condition)
        return tokens[:, self.num_context_tokens:, :]


class MLPMixerDecoder(nn.Module):
    """Query-token decoder: latent tokens ++ learned output queries through
    one mixer block, the query rows projected to ``output_dim``."""

    normal_init = ("output_queries", "condition_emb")

    def __init__(self, output_dim: int, num_latent_tokens: int = 32,
                 latent_dim: int = 512, num_output_tokens: int = 512,
                 token_mix_dim: int = 2048, channel_mix_dim: int = 2048,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_latent_tokens = num_latent_tokens
        self.compute_dtype = compute_dtype
        self.output_queries = nn.Parameter(
            torch.zeros(num_output_tokens, latent_dim))
        self.condition_emb = nn.Parameter(torch.zeros(latent_dim))
        self.block = MixerBlock(token_mix_dim, channel_mix_dim, latent_dim,
                                num_latent_tokens + num_output_tokens,
                                latent_dim, compute_dtype=compute_dtype)
        self.out = Dense(num_output_tokens * latent_dim, output_dim,
                         compute_dtype=compute_dtype)

    def forward(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        batch = latent_tokens.shape[0]
        queries, condition = _expand(self.output_queries, self.condition_emb,
                                     batch, self.compute_dtype)
        tokens = self.block(torch.cat(
            [latent_tokens.to(self.compute_dtype), queries], dim=1), condition)
        return self.out(tokens[:, self.num_latent_tokens:, :].reshape(batch,
                                                                      -1))


class ConditionalMLPMixerFlow(nn.Module):
    """Mixer conditional flow with an integrated query-token encoder:
    ``forward(x, time, latents)`` with ``time`` the ``[B, 2]`` (t, h) pair;
    ``latents=None`` equals zero latents (``latent_proj`` has no bias).
    The encoder mixes at a quarter of the decoder's widths."""

    architecture = "mlp_mixer"  # its table in weights.py

    def __init__(self, noise_dimension: int, condition_dimension: int,
                 num_blocks: int, latent_dimension: int,
                 token_mix_dim: int = 2048, channel_mix_dim: int = 2048,
                 num_channels: int = 16, num_latent_tokens: int = 32,
                 encoder_context_tokens: int = 64,
                 stage_tokens: int | None = None,
                 factorized_stages: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.noise_dimension = noise_dimension
        self.condition_dimension = condition_dimension
        self.latent_dimension = latent_dimension
        self.latent_shape = (num_latent_tokens, latent_dimension)
        self.compute_dtype = compute_dtype
        dt = dict(compute_dtype=compute_dtype)
        self.stages = nn.ModuleList([
            MixerStage(noise_dimension, condition_dimension, num_blocks,
                       token_mix_dim=token_mix_dim,
                       channel_mix_dim=channel_mix_dim,
                       num_channels=num_channels, num_tokens=stage_tokens,
                       factorized=factorized_stages, **dt)
            for _ in range(num_blocks)])
        self.latent_proj = Dense(num_latent_tokens * latent_dimension,
                                 condition_dimension, bias=False, **dt)
        self.encoder = MLPMixerEncoder(
            noise_dimension, num_latent_tokens=num_latent_tokens,
            latent_dim=latent_dimension,
            num_context_tokens=encoder_context_tokens,
            token_mix_dim=token_mix_dim // 4,
            channel_mix_dim=channel_mix_dim // 4, **dt)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, noise_dim] -> [B, num_latent_tokens, latent_dim]``."""
        return self.encoder(x.to(self.compute_dtype))

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                latents: torch.Tensor | None = None) -> torch.Tensor:
        cond = dual_time_embedding(time, self.condition_dimension).to(
            self.compute_dtype)
        if latents is not None:
            cond = cond + self.latent_proj(latents.reshape(latents.shape[0],
                                                           -1))
        h = x.to(self.compute_dtype)
        for stage in self.stages:
            h = stage(h, cond)
        return h


class MLPMixerAutoencoder(nn.Module):
    """``MLPMixerEncoder`` + ``MLPMixerDecoder``."""

    architecture = "mlp_mixer_autoencoder"  # its table in weights.py

    def __init__(self, input_dim: int, num_latent_tokens: int = 32,
                 latent_dim: int = 512, num_context_tokens: int = 512,
                 num_output_tokens: int = 512, token_mix_dim: int = 2048,
                 channel_mix_dim: int = 2048,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        mix = dict(token_mix_dim=token_mix_dim,
                   channel_mix_dim=channel_mix_dim,
                   compute_dtype=compute_dtype)
        self.encoder = MLPMixerEncoder(
            input_dim, num_latent_tokens=num_latent_tokens,
            latent_dim=latent_dim, num_context_tokens=num_context_tokens,
            **mix)
        self.decoder = MLPMixerDecoder(
            input_dim, num_latent_tokens=num_latent_tokens,
            latent_dim=latent_dim, num_output_tokens=num_output_tokens, **mix)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x.to(self.compute_dtype))

    def decode(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(latent_tokens)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
