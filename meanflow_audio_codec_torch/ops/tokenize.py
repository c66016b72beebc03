"""Audio <-> MDCT coefficient tokens.

Counterpart of ``MDCTTokenization`` and ``create_tokenization_strategy`` in
``meanflow_audio_codec_tpu/ops/tokenize.py``. The transforms go through the
kernel wrappers, which launch the CUDA kernels on CUDA tensors and run the
plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from meanflow_audio_codec_torch.ops.imdct_cuda import imdct_cuda
from meanflow_audio_codec_torch.ops.mdct import MDCTConfig
from meanflow_audio_codec_torch.ops.mdct_cuda import mdct_cuda


class MDCTTokenization:
    """Mono ``[B, T] -> [B, nf, W]``; multichannel ``[B, T, C] -> [B, nf, W*C]``
    with the channels concatenated channel-major along the coefficient axis."""

    def __init__(self, window_size: int = 512, hop_size: int | None = None,
                 config: MDCTConfig | None = None):
        self.config = config if config is not None else MDCTConfig(
            window_size=window_size, hop_size=hop_size)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            return mdct_cuda(x.contiguous(), self.config)
        if x.ndim == 3:
            # [B, T, C] -> [B, C, T]: one transform over B*C rows
            coeffs = mdct_cuda(x.movedim(-1, 1).contiguous(), self.config)
            b, c, nf, w = coeffs.shape
            # [B, C, nf, W] -> [B, nf, C*W]
            return coeffs.movedim(1, -2).reshape(b, nf, c * w)
        raise ValueError(f"Invalid input shape for MDCT: {tuple(x.shape)}")

    def detokenize(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.ndim != 3:
            raise ValueError(f"Invalid tokens shape: {tuple(tokens.shape)}, "
                             "expected [B, n_frames, ...]")
        w = self.config.window_size
        b, nf, token_dim = tokens.shape
        if token_dim == w:
            return imdct_cuda(tokens.contiguous(), self.config)
        if token_dim % w != 0:
            raise ValueError(
                f"Invalid tokens shape: {tuple(tokens.shape)}, token_dim "
                f"({token_dim}) must be multiple of window_size ({w})")
        channels = token_dim // w
        # [B, nf, C, W] -> [B, C, nf, W]: one inverse over B*C rows
        per_channel = tokens.reshape(b, nf, channels, w).movedim(2, 1)
        audio = imdct_cuda(per_channel.contiguous(), self.config)  # [B, C, T]
        return audio.movedim(1, -1)  # [B, T, C]


def create_tokenization_strategy(strategy: str | None,
                                 tokenization_config: dict | None = None
                                 ) -> MDCTTokenization:
    """Build the tokenizer a config names; mdct keys: window_size, hop_size."""
    cfg = dict(tokenization_config or {})
    if strategy in (None, "mdct"):
        return MDCTTokenization(window_size=cfg.get("window_size", 512),
                                hop_size=cfg.get("hop_size"))
    raise ValueError(f"Unsupported tokenization strategy in the port: "
                     f"{strategy!r} (only 'mdct')")
