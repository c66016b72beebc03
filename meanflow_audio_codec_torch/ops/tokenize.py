"""Tokenization strategies: data <-> ``[B, n_tokens, token_dim]`` tokens.

Counterpart of ``meanflow_audio_codec_tpu/ops/tokenize.py``:
``MDCTTokenization`` (audio <-> MDCT coefficients; the transforms go through
the kernel wrappers, which launch the CUDA kernels on CUDA tensors and run
the plain versions on CPU tensors), ``ReshapeTokenization`` (image patches,
fixed-length audio patches), ``create_tokenization_strategy``,
``compute_token_shape`` and ``PreprocessingPipeline``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from meanflow_audio_codec_torch.ops.imdct_cuda import imdct_cuda
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    num_frames_for_length,
)
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


def patchify_image(x: torch.Tensor, patch_h: int, patch_w: int
                   ) -> torch.Tensor:
    """``[B, H, W, C] -> [B, (H/p1)(W/p2), p1*p2*C]`` (ViT patches)."""
    b, h, w, c = x.shape
    gh, gw = h // patch_h, w // patch_w
    x = x.reshape(b, gh, patch_h, gw, patch_w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_h * patch_w * c)


def unpatchify_image(tokens: torch.Tensor, grid_h: int, grid_w: int,
                     patch_h: int, patch_w: int, channels: int
                     ) -> torch.Tensor:
    """Inverse of :func:`patchify_image`."""
    b = tokens.shape[0]
    x = tokens.reshape(b, grid_h, grid_w, patch_h, patch_w, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid_h * patch_h, grid_w * patch_w, channels)


class ReshapeTokenization:
    """Patch tokenizer for images; fixed-length patches for audio.

    Flat ``[B, H*W]`` images are recognised by ``image_size``/``patch_size``
    or, without hints, by their 784 pixels (MNIST); audio is cut into
    ``patch_length``-sample tokens (default 128) with zero padding, a
    multichannel ``[B, T, C]`` clip flattened time-major first.
    """

    def __init__(self, patch_size: int | tuple[int, int] | None = None,
                 patch_length: int | None = None,
                 image_size: int | tuple[int, int] | None = None):
        self.patch_size = patch_size
        self.patch_length = patch_length
        self.image_size = image_size

    # ---- dispatch ------------------------------------------------------------
    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        hints = self.image_size is not None or self.patch_size is not None
        if x.ndim == 2:
            if hints:
                return self._tokenize_image(x)
            if self.patch_length is not None:
                return self._tokenize_audio(x)
            return (self._tokenize_image(x) if x.shape[1] == 784
                    else self._tokenize_audio(x))
        if x.ndim == 3:
            if x.shape[2] in (1, 3):
                return self._tokenize_image(x)
            # [B, H, W] images are recognised by explicit geometry hints;
            # otherwise 3-d input is multichannel audio [B, T, C]
            if hints and self.patch_length is None:
                return self._tokenize_image(x)
            return self._tokenize_audio(x)
        if x.ndim == 4:
            return self._tokenize_image(x)
        raise ValueError("Invalid input shape for reshape tokenization: "
                         f"{tuple(x.shape)}")

    def detokenize(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.patch_size is not None or self.image_size is not None:
            return self._detokenize_image(tokens)
        if self.patch_length is not None:
            return self._detokenize_audio(tokens)
        patch_dim = tokens.shape[2]
        root = math.isqrt(patch_dim)
        if root * root == patch_dim and root <= 16:
            return self._detokenize_image(tokens)
        return self._detokenize_audio(tokens)

    # ---- geometry ------------------------------------------------------------
    @staticmethod
    def _pair(size: int | tuple[int, int]) -> tuple[int, int]:
        return (size, size) if isinstance(size, int) else tuple(size)

    def _patch_hw(self) -> tuple[int, int]:
        return (4, 4) if self.patch_size is None else self._pair(
            self.patch_size)

    def _image_hw(self, flat_dim: int | None = None) -> tuple[int, int]:
        if self.image_size is None:
            if flat_dim is None:
                raise ValueError("image_size required to infer geometry")
            side = math.isqrt(flat_dim)
            return side, side
        return self._pair(self.image_size)

    def _infer_patch_geometry(self, patch_dim: int) -> tuple[int, int]:
        if self.patch_size is not None:
            return self._patch_hw()
        root = math.isqrt(patch_dim)
        if root * root == patch_dim:
            return root, root
        for p in (2, 4, 7, 8):
            if patch_dim % (p * p) == 0:
                return p, p
        return 4, 4

    # ---- images ---------------------------------------------------------------
    def _tokenize_image(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            x = x.reshape(x.shape[0], *self._image_hw(x.shape[1]))
        if x.ndim == 3:
            x = x[..., None]
        return patchify_image(x, *self._patch_hw())

    def _detokenize_image(self, tokens: torch.Tensor) -> torch.Tensor:
        _, n_patches, patch_dim = tokens.shape
        patch_h, patch_w = self._infer_patch_geometry(patch_dim)
        channels = patch_dim // (patch_h * patch_w)
        if self.image_size is not None:
            h, w = self._image_hw()
            grid_h, grid_w = h // patch_h, w // patch_w
        else:
            grid_h = grid_w = math.isqrt(n_patches)
        x = unpatchify_image(tokens, grid_h, grid_w, patch_h, patch_w,
                             channels)
        return x[..., 0] if x.shape[-1] == 1 else x

    # ---- audio ----------------------------------------------------------------
    def _tokenize_audio(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 3:
            x = x.reshape(x.shape[0], -1)
        patch_length = self.patch_length or 128
        n_patches = -(-x.shape[1] // patch_length)
        x = F.pad(x, (0, n_patches * patch_length - x.shape[1]))
        return x.reshape(x.shape[0], n_patches, patch_length)

    @staticmethod
    def _detokenize_audio(tokens: torch.Tensor) -> torch.Tensor:
        b, n_patches, patch_length = tokens.shape
        return tokens.reshape(b, n_patches * patch_length)


TokenizationStrategy = MDCTTokenization | ReshapeTokenization


def create_tokenization_strategy(strategy: str | None,
                                 tokenization_config: dict | None = None
                                 ) -> TokenizationStrategy:
    """Build the tokenizer a config names. mdct keys: window_size,
    hop_size; reshape keys: patch_size, patch_length, image_size."""
    cfg = dict(tokenization_config or {})
    if strategy in (None, "mdct"):
        return MDCTTokenization(window_size=cfg.get("window_size", 512),
                                hop_size=cfg.get("hop_size"))
    if strategy == "reshape":
        return ReshapeTokenization(patch_size=cfg.get("patch_size"),
                                   patch_length=cfg.get("patch_length"),
                                   image_size=cfg.get("image_size"))
    raise ValueError(f"Unknown tokenization strategy: {strategy!r}")


def compute_token_shape(strategy: TokenizationStrategy,
                        input_shape: tuple[int, ...]) -> tuple[int, int]:
    """(n_tokens, token_dim) of one example of ``input_shape``: closed form
    for the MDCT, a zero probe through the (pure reshape) tokenizer
    otherwise."""
    if isinstance(strategy, MDCTTokenization):
        w, hop = strategy.config.window_size, strategy.config.hop_size
        channels = input_shape[1] if len(input_shape) > 1 else 1
        return num_frames_for_length(input_shape[0], w, hop), w * channels
    tokens = strategy.tokenize(torch.zeros((1,) + tuple(input_shape)))
    return int(tokens.shape[1]), int(tokens.shape[2])


def compute_tokenized_dimension(strategy: TokenizationStrategy,
                                input_shape: tuple[int, ...]) -> int:
    """Flattened ``n_tokens * token_dim``: the features-layout noise width."""
    n_tokens, token_dim = compute_token_shape(strategy, input_shape)
    return n_tokens * token_dim


class PreprocessingPipeline:
    """Tokenizers applied in order; the inverse applies them reversed."""

    def __init__(self, steps: list):
        self.steps = list(steps)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        for step in self.steps:
            x = step.tokenize(x)
        return x

    def detokenize(self, tokens: torch.Tensor) -> torch.Tensor:
        for step in reversed(self.steps):
            tokens = step.detokenize(tokens)
        return tokens
