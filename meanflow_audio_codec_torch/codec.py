"""User-facing audio codec: encode audio -> latents, 1-NFE decode -> audio.

Counterpart of ``AudioCodec`` in ``meanflow_audio_codec_tpu/codec.py``
(encode, encode_with_gains, decode, roundtrip). Each MDCT frame is one
example of the flow, so the latent sequence grows with the audio.

    model = create_flow_model(config)
    codec = AudioCodec(model, state_dict, config)   # device="cuda"
    latents, gains = codec.encode_with_gains(audio)  # [B, nf, latent], [B, nf, 1]
    recon = codec.decode(latents, gains=gains)       # [B, T', C]
    recon = codec.roundtrip(audio)
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.ops.sampling import sample_dual_time
from meanflow_audio_codec_torch.ops.tokenize import create_tokenization_strategy
from meanflow_audio_codec_torch.training.adapter import (
    adapter_from_config,
    resolve_flatten_mode,
)


class AudioCodec:
    """Tokenizer + encoder + 1-NFE flow decoder, in inference mode.

    ``state_dict`` is loaded strictly into ``model`` when given (use
    :func:`meanflow_audio_codec_torch.weights.flax_to_torch` for Flax
    params); ``None`` keeps the model's own weights.
    """

    def __init__(self, model: nn.Module, state_dict: Mapping | None,
                 config: CodecConfig, device: str | torch.device = "cuda"):
        mode = resolve_flatten_mode(config)
        if mode != "frames":
            raise ValueError(
                "AudioCodec requires the per-frame token layout (audio "
                f"dataset + mdct tokenization); got flatten mode {mode!r}")
        self.device = resolve_device(device)
        self.config = config
        strategy = create_tokenization_strategy(config.tokenization_strategy,
                                                config.tokenization_config)
        self.adapter = adapter_from_config(config, strategy)
        self.noise_dim = config.noise_dimension
        self.latent_dim = config.latent_dimension
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()

    def _tensor(self, value, dtype: torch.dtype | None = None) -> torch.Tensor:
        """A numpy array or tensor on this codec's device."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.array(value))  # writable copy
        return value.to(device=self.device, dtype=dtype)

    @torch.no_grad()
    def encode_with_gains(self, audio) -> tuple[torch.Tensor, torch.Tensor]:
        """``[B, T, C]`` audio -> (latents ``[B, nf, latent_dim]``, gains
        ``[B, nf, 1]``). Gains are all ones unless the config sets
        ``gain_norm``."""
        flat, gains = self.adapter.tokenize_with_gain(
            self._tensor(audio, torch.float32))
        b, nf = gains.shape[:2]
        return self.model.encode(flat).reshape(b, nf, -1), gains

    def encode(self, audio) -> torch.Tensor:
        """``[B, T, C]`` audio -> ``[B, nf, latent_dim]`` latents."""
        return self.encode_with_gains(audio)[0]

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, nfe: int = 1,
               generator: torch.Generator | None = None,
               gains: torch.Tensor | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """``[B, nf, latent_dim]`` -> ``[B, T', C]`` audio in ``nfe`` model calls.

        The start noise is drawn from ``generator`` (on this codec's device)
        unless ``noise`` (``[B*nf, noise_dim]``) is given. ``gains`` restores
        the per-frame energy of a gain-normalised codec.
        """
        latents = self._tensor(latents)
        b, nf, _ = latents.shape
        if noise is not None:
            noise = self._tensor(noise)
        flat = sample_dual_time(self.model, self.noise_dim,
                                latents.reshape(b * nf, -1), n_steps=int(nfe),
                                noise=noise, generator=generator)
        if gains is not None:
            gains = self._tensor(gains)
        return self.adapter.detokenize_flat(flat, (nf, self.noise_dim),
                                            gains=gains)

    def roundtrip(self, audio, nfe: int = 1,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
        """encode + decode; the reconstruction the quality metrics score."""
        latents, gains = self.encode_with_gains(audio)
        return self.decode(latents, nfe=nfe, generator=generator,
                           gains=gains if self.adapter.gain_norm else None,
                           noise=noise)
