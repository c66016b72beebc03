"""Time embeddings; counterpart of ``meanflow_audio_codec_tpu/ops/embeddings.py``."""

from __future__ import annotations

import math

import torch


def sinusoidal_embedding(x: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """``[B] -> [B, dim]`` float32 embedding ``[cos(x f), sin(x f)]`` with
    ``f_i = exp(-log(max_period) * i / (dim // 2))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    args = x[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dual_time_embedding(time: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B, 2]`` (t, h=t-r) pairs -> ``[B, dim]`` embedding ``emb(t) + emb(h)``."""
    return (sinusoidal_embedding(time[:, 0], dim)
            + sinusoidal_embedding(time[:, 1], dim))
