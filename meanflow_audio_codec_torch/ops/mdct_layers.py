"""Parameter-free MDCT layers; counterpart of
``meanflow_audio_codec_tpu/ops/mdct_layers.py``.

Stereo inputs fold their channels into the batch (one transform over
``B * 2`` rows), with the left and right coefficient blocks concatenated
along the frequency axis, as in the JAX package. The transforms go through
the kernel wrappers (``ops/mdct_cuda.py``, ``ops/imdct_cuda.py``): the CUDA
kernels on the card, the plain versions on the CPU, differentiable on both.
``use_fft_threshold`` is where the CPU's plain versions take the FFT path;
the card's kernels take every W.
"""

from __future__ import annotations

import torch
from torch import nn

from meanflow_audio_codec_torch.ops.imdct_cuda import imdct_cuda
from meanflow_audio_codec_torch.ops.mdct import (
    DEFAULT_FFT_THRESHOLD,
    DEFAULT_WINDOW_SIZE,
    MDCTConfig,
)
from meanflow_audio_codec_torch.ops.mdct_cuda import mdct_cuda


def _config(window_size: int, hop_size: int | None, use_fft_threshold: int,
            config: MDCTConfig | None) -> MDCTConfig:
    return config if config is not None else MDCTConfig(
        window_size=window_size, hop_size=hop_size,
        use_fft_threshold=use_fft_threshold)


class MDCTLayer(nn.Module):
    """Forward MDCT: ``[B, T] -> [B, n_frames, W]`` (mono) or ``[B, T, 2] ->
    [B, n_frames, 2W]`` (stereo, the L block then the R block)."""

    def __init__(self, window_size: int = DEFAULT_WINDOW_SIZE,
                 hop_size: int | None = None,
                 use_fft_threshold: int = DEFAULT_FFT_THRESHOLD,
                 config: MDCTConfig | None = None):
        super().__init__()
        self.config = _config(window_size, hop_size, use_fft_threshold,
                              config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 3 and x.shape[-1] == 2:
            coeffs = mdct_cuda(x.movedim(-1, 1).contiguous(), self.config)
            b, c, nf, w = coeffs.shape  # [B, 2, nf, W]
            return coeffs.movedim(1, -2).reshape(b, nf, c * w)
        return mdct_cuda(x.contiguous(), self.config)


class IMDCTLayer(nn.Module):
    """Inverse MDCT: ``[B, n_frames, W] -> [B, T]`` (mono) or ``[B,
    n_frames, 2W] -> [B, T, 2]`` (stereo)."""

    def __init__(self, window_size: int = DEFAULT_WINDOW_SIZE,
                 hop_size: int | None = None,
                 use_fft_threshold: int = DEFAULT_FFT_THRESHOLD,
                 config: MDCTConfig | None = None):
        super().__init__()
        self.config = _config(window_size, hop_size, use_fft_threshold,
                              config)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        w = self.config.window_size
        if X.shape[-1] == 2 * w:
            b, nf, _ = X.shape
            per_channel = X.reshape(b, nf, 2, w).movedim(2, 1).contiguous()
            return imdct_cuda(per_channel, self.config).movedim(1, -1)
        return imdct_cuda(X.contiguous(), self.config)
