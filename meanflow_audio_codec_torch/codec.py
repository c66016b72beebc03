"""User-facing audio codec: encode audio -> latents, 1-NFE decode -> audio,
and the stored bytes in between.

Counterpart of ``AudioCodec`` in ``meanflow_audio_codec_tpu/codec.py``. Each
MDCT frame is one example of the flow, so the latent sequence grows with the
audio.

    codec = AudioCodec.from_workdir("outputs/imf_frontier_v2")  # device="cuda"
    int8 = AudioCodec.from_workdir("outputs/imf_frontier_v2", quantized=True)
    data = codec.encode_bytes(audio)                 # MACB, rANS-coded
    recon = codec.decode_bytes(data)                 # [B, T', C]
    recon = codec.roundtrip(audio)
    duplex = codec.streaming()                       # chunked, streaming.py

or, from a model the caller builds:

    codec = AudioCodec(create_flow_model(config), state_dict, config)
    latents, gains = codec.encode_with_gains(audio)  # [B, nf, latent], [B, nf, 1]
    recon = codec.decode(latents, gains=gains)

``encode_with_gains`` and ``decode`` are the root spans ``codec.encode``
(over ``codec.tokenize`` and ``codec.encoder``) and ``codec.decode`` (over
``codec.flow`` and ``codec.detokenize``), each counting its frame rows
(``tracing``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

from meanflow_audio_codec_torch import tracing
from meanflow_audio_codec_torch.configs import CodecConfig, load_config
from meanflow_audio_codec_torch.data.audio import TARGET_SAMPLE_RATE
from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.ops import latent_quant
from meanflow_audio_codec_torch.ops.sampling import sample_dual_time
from meanflow_audio_codec_torch.ops.tokenize import create_tokenization_strategy
from meanflow_audio_codec_torch.training import checkpoints
from meanflow_audio_codec_torch.training.adapter import (
    adapter_from_config,
    resolve_flatten_mode,
)
from meanflow_audio_codec_torch.training.trainer import (
    effective_noise_dimension,
    load_flow_state,
)


def with_quantized_decoder(config: CodecConfig) -> CodecConfig:
    """``config`` with ``architecture_options["quantized"] = True``: the
    convnet decoder in W8A8 int8 (another family's factory refuses the
    option with a ``TypeError``, as in the JAX package)."""
    return dataclasses.replace(config, architecture_options={
        **config.architecture_options, "quantized": True})


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

    # ---- construction --------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, checkpoint_path: Path | str, config: CodecConfig,
                        device: str | torch.device = "cuda",
                        quantized: bool = False) -> "AudioCodec":
        """Serve a checkpoint: the EMA parameters when it holds them, else
        the live ones (a full ``step_N.msgpack``, a ``step_N.orbax``
        directory or a ``serving_step_N.msgpack``). ``quantized`` serves
        the same checkpoint through the dynamic W8A8 int8 decoder
        (``ops/quant.py``; the parameters are unchanged, the encoder stays
        in the compute dtype)."""
        if quantized:
            config = with_quantized_decoder(config)
        noise_dim = effective_noise_dimension(config)
        if noise_dim != config.noise_dimension:
            config = dataclasses.replace(config, noise_dimension=noise_dim)
        state, model = load_flow_state(checkpoint_path, config, device=device)
        served = state.ema if state.ema is not None else state.params
        return cls(model, dict(zip(state.names, served)), config,
                   device=device)

    @classmethod
    def from_workdir(cls, workdir: Path | str,
                     device: str | torch.device = "cuda",
                     quantized: bool = False) -> "AudioCodec":
        """Serve a run directory with its saved ``config.json``: the newest
        full checkpoint, and only when there is none the newest serving
        file (as the JAX package picks; a newer serving file does not win
        over an older full checkpoint)."""
        workdir = Path(workdir)
        config = load_config(workdir / "config.json")
        checkpoint_dir = workdir / "checkpoints"
        checkpoint = (checkpoints.find_latest_checkpoint(checkpoint_dir)
                      or checkpoints.find_latest_serving_checkpoint(
                          checkpoint_dir))
        if checkpoint is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        return cls.from_checkpoint(checkpoint, config, device=device,
                                   quantized=quantized)

    def _tensor(self, value, dtype: torch.dtype | None = None) -> torch.Tensor:
        """A numpy array or tensor on this codec's device."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.array(value))  # writable copy
        return value.to(device=self.device, dtype=dtype)

    # ---- latents -------------------------------------------------------------
    @torch.no_grad()
    def _encode_tokens(self, tokens: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """``[B, nf, W*C]`` MDCT tokens -> (latents, gains)."""
        with tracing.span("codec.encoder"):
            flat, gains = self.adapter.scale_and_gain(tokens)
            b, nf = gains.shape[:2]
            return self.model.encode(flat).reshape(b, nf, -1), gains

    def encode_with_gains(self, audio) -> tuple[torch.Tensor, torch.Tensor]:
        """``[B, T, C]`` audio -> (latents ``[B, nf, latent_dim]``, gains
        ``[B, nf, 1]``). Gains are all ones unless the config sets
        ``gain_norm``."""
        with tracing.root("codec.encode", self.device):
            with tracing.span("codec.tokenize"):
                tokens = self.adapter.strategy.tokenize(
                    self._tensor(audio, torch.float32))
            latents, gains = self._encode_tokens(tokens)
            tracing.rows(latents, 2)
        return latents, gains

    def encode(self, audio) -> torch.Tensor:
        """``[B, T, C]`` audio -> ``[B, nf, latent_dim]`` latents."""
        return self.encode_with_gains(audio)[0]

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, nfe: int = 1,
               generator: torch.Generator | None = None,
               gains: torch.Tensor | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """``[B, nf, latent_dim]`` -> ``[B, T', C]`` audio in ``nfe`` model calls.

        The start noise (``[B*nf, noise_dim]``) is ``noise`` when given, else
        drawn from ``generator`` on this codec's device, else from a fresh
        generator seeded 0, so ``decode(x)`` gives the same audio every
        time. ``gains`` restores the per-frame energy of a gain-normalised
        codec.
        """
        with tracing.root("codec.decode", self.device):
            latents = self._tensor(latents)
            b, nf, _ = latents.shape
            tracing.rows(latents, 2)
            if noise is not None:
                noise = self._tensor(noise)
            elif generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            with tracing.span("codec.flow"):
                flat = sample_dual_time(self.model, self.noise_dim,
                                        latents.reshape(b * nf, -1),
                                        n_steps=int(nfe), noise=noise,
                                        generator=generator)
            if gains is not None:
                gains = self._tensor(gains)
            with tracing.span("codec.detokenize"):
                return self.adapter.detokenize_flat(
                    flat, (nf, self.noise_dim), gains=gains)

    def roundtrip(self, audio, nfe: int = 1,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
        """encode + decode; the reconstruction the quality metrics score."""
        latents, gains = self.encode_with_gains(audio)
        return self.decode(latents, nfe=nfe, generator=generator,
                           gains=gains if self.adapter.gain_norm else None,
                           noise=noise)

    def streaming(self, seed: int = 0, nfe: int = 1, noise_fn=None):
        """Full-duplex chunked codec (``streaming.StreamingCodec``)."""
        from meanflow_audio_codec_torch.streaming import StreamingCodec
        return StreamingCodec(self, seed=seed, nfe=nfe, noise_fn=noise_fn)

    # ---- bitstream (stored format) -------------------------------------------
    def encode_packed(self, audio, bits: int = 8,
                      step_frac: float | None = None
                      ) -> latent_quant.LatentBitstream:
        """audio -> quantized ``LatentBitstream`` on this codec's device.

        Per-frame symmetric codes of ``bits`` (MACB v1), or with
        ``step_frac`` the mean-removed ECSQ format (MACB v2). A
        gain-normalised codec stores its gains on the 8-bit log grid the
        bytes carry, so in-memory and from-bytes decodes are equal bit for
        bit.
        """
        latents, gains = self.encode_with_gains(audio)
        return self.quantize(latents, gains, bits=bits, step_frac=step_frac)

    def quantize(self, latents: torch.Tensor, gains: torch.Tensor,
                 bits: int = 8, step_frac: float | None = None
                 ) -> latent_quant.LatentBitstream:
        """The ``LatentBitstream`` of ``encode_with_gains``'s output (see
        :meth:`encode_packed`)."""
        if step_frac is not None:
            stream = latent_quant.quantize_latents_ecsq(latents,
                                                        step_frac=step_frac)
        else:
            stream = latent_quant.quantize_latents(latents, bits=bits)
        if self.adapter.gain_norm:
            grid = latent_quant.dequantize_gains(latent_quant.quantize_gains(
                gains.cpu().numpy()))
            stream = dataclasses.replace(stream, gains=self._tensor(grid))
        return stream

    def decode_packed(self, bitstream: latent_quant.LatentBitstream,
                      nfe: int = 1, generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
        """``LatentBitstream`` -> audio; the flow decode doubles as the
        dequantization post-filter."""
        bitstream = bitstream.to(self.device)
        return self.decode(latent_quant.dequantize_latents(bitstream),
                           nfe=nfe, generator=generator,
                           gains=bitstream.gains, noise=noise)

    def bitrate_kbps(self, bits: int = 8) -> float:
        """Nominal stored bitrate (codes + per-frame scale) before entropy
        coding; ``encode_bytes`` gives the stored rate."""
        return latent_quant.bitstream_kbps(self.latent_dim,
                                           self.frames_per_second, bits=bits)

    def encode_bytes(self, audio, bits: int = 8,
                     step_frac: float | None = None) -> bytes:
        """audio -> stored bytes: quantize, then rANS-code (the write path)."""
        return latent_quant.pack_bitstream(
            self.encode_packed(audio, bits=bits, step_frac=step_frac))

    def decode_bytes(self, data: bytes, nfe: int = 1,
                     generator: torch.Generator | None = None,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
        """Stored bytes -> audio (the read path)."""
        return self.decode_packed(latent_quant.unpack_bitstream(data),
                                  nfe=nfe, generator=generator, noise=noise)

    # ---- metadata ------------------------------------------------------------
    @property
    def _hop(self) -> int:
        return int(self.adapter.strategy.config.hop_size)

    @property
    def _channels(self) -> int:
        """Audio channels implied by the frame token width."""
        window = int(self.adapter.strategy.config.window_size)
        return max(1, self.noise_dim // window)

    @property
    def frames_per_second(self) -> float:
        """Latent frame rate at 44.1 kHz."""
        return TARGET_SAMPLE_RATE / self._hop

    @property
    def compression_ratio(self) -> float:
        """Raw samples per frame / latent dims per frame (f32 latents)."""
        return (self._hop * self._channels) / float(self.latent_dim)
