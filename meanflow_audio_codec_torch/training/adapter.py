"""Token scaling, gain and flattening; counterpart of
``resolve_flatten_mode``, ``TokenAdapter`` and ``adapter_from_config`` in
``meanflow_audio_codec_tpu/training/trainer.py``.

Two layouts: ``frames`` (audio + MDCT, the codec's: every frame one flow
example ``[B*nf, token_dim]``) and ``features`` (every example one flat
vector ``[B, n_tokens*token_dim]``: images, and audio through the reshape
tokenizer)."""

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
    """Tokenize + scale + flatten to flow examples of the ``mode`` layout,
    and back.

    ``scale`` divides tokens on the way in and multiplies on the way out.
    ``gain_norm`` > 0 normalises every flow example (a frame in ``frames``
    mode, a clip in ``features`` mode) to unit RMS with gain
    ``sqrt(mean(tok^2) + gain_norm^2)``; the gain is side information the
    decode restores.
    """

    def __init__(self, strategy, scale: float = 1.0, gain_norm: float = 0.0,
                 mode: str = "frames"):
        if mode not in ("frames", "features"):
            raise ValueError(f"flatten mode must be 'frames' or 'features', "
                             f"got {mode!r}")
        self.strategy = strategy
        self.scale = float(scale)
        self.gain_norm = float(gain_norm)
        self.mode = mode

    def gains(self, tokens: torch.Tensor) -> torch.Tensor:
        """RMS gain of ``[B, nf, D]`` scaled tokens: per frame ``[B, nf, 1]``
        in ``frames`` mode, per clip ``[B, 1, 1]`` in ``features`` mode."""
        dims = (-1,) if self.mode == "frames" else (-2, -1)
        ms = (tokens * tokens).mean(dim=dims, keepdim=True)
        return torch.sqrt(ms + self.gain_norm * self.gain_norm)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        """Flat, scaled, gain-normalised tokens, ``[B*nf, D]`` or ``[B,
        nf*D]`` (the train step's input)."""
        return self.tokenize_with_gain(x)[0]

    def tokenize_with_gain(self, x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """Flat tokens and the gains (``[B, nf, 1]`` per frame) the decode
        needs to undo the normalisation (all ones with ``gain_norm`` off)."""
        return self.scale_and_gain(self.strategy.tokenize(x))

    def scale_and_gain(self, tokens: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`tokenize_with_gain` of tokenizer output ``[B, nf, D]``."""
        if self.scale != 1.0:
            tokens = tokens / self.scale
        if self.gain_norm:
            gains = self.gains(tokens)
            tokens = tokens / gains
        else:
            gains = tokens.new_ones(tokens.shape[:2] + (1,))
        if self.mode == "frames":
            return tokens.reshape(-1, tokens.shape[-1]), gains
        return tokens.reshape(tokens.shape[0], -1), gains

    def detokenize_flat(self, flat: torch.Tensor, token_shape: tuple[int, int],
                        gains: torch.Tensor | None = None) -> torch.Tensor:
        n_tokens, token_dim = token_shape
        batch = -1 if self.mode == "frames" else flat.shape[0]
        tokens = flat.reshape(batch, n_tokens, token_dim)
        if gains is not None:
            tokens = tokens * gains
        if self.scale != 1.0:
            tokens = tokens * self.scale
        return self.strategy.detokenize(tokens)


def adapter_from_config(config: CodecConfig, strategy,
                        mode: str | None = None) -> TokenAdapter:
    """The token adapter of the config's layout (or of ``mode``, when
    given), with its ``coeff_scale`` and ``gain_norm``."""
    tok_cfg = config.tokenization_config
    return TokenAdapter(strategy,
                        scale=tok_cfg.get("coeff_scale", 1.0),
                        gain_norm=tok_cfg.get("gain_norm", 0.0),
                        mode=resolve_flatten_mode(config) if mode is None
                        else mode)
