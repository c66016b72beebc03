"""Token scaling and per-frame gain; counterpart of ``resolve_flatten_mode``,
``TokenAdapter`` and ``adapter_from_config`` in
``meanflow_audio_codec_tpu/training/trainer.py``, for the per-frame
('frames') layout the codec and its train step use."""

from __future__ import annotations

import torch

from meanflow_audio_codec_torch.configs import CodecConfig


def resolve_flatten_mode(config: CodecConfig) -> str:
    """'frames' for audio + mdct (the per-frame codec layout) unless the
    tokenization config overrides it."""
    tok_cfg = config.tokenization_config
    if "flatten" in tok_cfg:
        return tok_cfg["flatten"]
    if (config.dataset == "audio"
            and (config.tokenization_strategy or "mdct") == "mdct"):
        return "frames"
    return "features"


class TokenAdapter:
    """Tokenize + scale + flatten to one flow example per frame, and back.

    ``scale`` divides tokens on the way in and multiplies on the way out.
    ``gain_norm`` > 0 normalises every frame to unit RMS with gain
    ``sqrt(mean(tok^2) + gain_norm^2)``; the gain is side information the
    decode restores.
    """

    def __init__(self, strategy, scale: float = 1.0, gain_norm: float = 0.0):
        self.strategy = strategy
        self.scale = float(scale)
        self.gain_norm = float(gain_norm)

    def gains(self, tokens: torch.Tensor) -> torch.Tensor:
        """Per-frame RMS gain ``[B, nf, 1]`` of ``[B, nf, D]`` scaled tokens."""
        ms = (tokens * tokens).mean(dim=-1, keepdim=True)
        return torch.sqrt(ms + self.gain_norm * self.gain_norm)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        """Flat, scaled, gain-normalised tokens ``[B*nf, D]`` (the train
        step's input)."""
        return self.tokenize_with_gain(x)[0]

    def tokenize_with_gain(self, x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """Flat tokens ``[B*nf, D]`` and the gains ``[B, nf, 1]`` the decode
        needs to undo the normalisation (all ones with ``gain_norm`` off)."""
        tokens = self.strategy.tokenize(x)
        if self.scale != 1.0:
            tokens = tokens / self.scale
        if self.gain_norm:
            gains = self.gains(tokens)
            tokens = tokens / gains
        else:
            gains = tokens.new_ones(tokens.shape[:2] + (1,))
        return tokens.reshape(-1, tokens.shape[-1]), gains

    def detokenize_flat(self, flat: torch.Tensor, token_shape: tuple[int, int],
                        gains: torch.Tensor | None = None) -> torch.Tensor:
        n_tokens, token_dim = token_shape
        tokens = flat.reshape(-1, n_tokens, token_dim)
        if gains is not None:
            tokens = tokens * gains
        if self.scale != 1.0:
            tokens = tokens * self.scale
        return self.strategy.detokenize(tokens)


def adapter_from_config(config: CodecConfig, strategy) -> TokenAdapter:
    """The token adapter with the config's ``coeff_scale`` and ``gain_norm``."""
    tok_cfg = config.tokenization_config
    return TokenAdapter(strategy,
                        scale=tok_cfg.get("coeff_scale", 1.0),
                        gain_norm=tok_cfg.get("gain_norm", 0.0))
