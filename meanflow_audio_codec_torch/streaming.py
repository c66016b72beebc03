"""Streaming (chunked, stateful) codec on top of ``AudioCodec``.

Counterpart of ``meanflow_audio_codec_tpu/streaming.py``. Pushing a signal
through :class:`StreamingEncoder` in any chunking gives the latents of
``AudioCodec.encode`` on the whole signal; :class:`StreamingDecoder` gives
the same samples for any chunking of the same latents, because each frame's
start noise depends only on (seed, batch row, absolute frame index)
(:func:`frame_noise`). The JAX package keys that noise with
``jax.random.fold_in``, which torch cannot reproduce; a decoder takes an
injected ``noise_fn`` when a caller needs other noise (the tests feed it the
JAX package's ``frame_noise``).

Geometry (ops/mdct.py): frame ``j`` reads samples ``[jH, jH + 2W)``. The
encoder carries the last ``< 2W`` samples no emitted frame has finished
with; the decoder carries a ``2W - H``-sample overlap-add tail. The duplex
latency is ``2W - H`` samples (768 at W=512, hop 256: 17.4 ms at 44.1 kHz).
On the card every encoder ``push`` runs the MDCT kernel and every decoder
``push`` the IMDCT kernel, at the chunk's shapes.

    codec = AudioCodec.from_workdir("outputs/imf_frontier_v2")
    duplex = codec.streaming()
    for chunk in mic:                       # [B, S, C], S % hop == 0
        play(duplex.push(chunk))
    play(duplex.flush())                    # trailing frames and tail
"""

from __future__ import annotations

import dataclasses
import math

import torch

from meanflow_audio_codec_torch.ops import latent_quant
from meanflow_audio_codec_torch.ops.mdct import num_frames_for_length

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser: every input bit moves every output
    bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def frame_noise(seed: int, start: int, n: int, batch: int, dim: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-frame decode noise ``[batch, n, dim]`` of standard normals.

    Row ``(b, start + i)`` is a pure function of ``seed``, ``b`` and the
    absolute frame index ``start + i`` (taken mod 2**32): a counter-based
    integer hash gives two uniforms per pair of values, Box-Muller turns
    them into normals. Vectorised over the whole chunk.
    """
    kw = dict(device=device, dtype=torch.int64)
    rows = torch.arange(batch, **kw)[:, None, None]
    frames = (start + torch.arange(n, **kw))[None, :, None] & _M32
    pairs = torch.arange((dim + 1) // 2, **kw)[None, None, :]
    h = _fmix32(_fmix32(rows ^ (seed & _M32)) ^ frames)
    a = _fmix32(h ^ _mul32(2 * pairs + 1, _GOLDEN))
    b = _fmix32(h ^ _mul32(2 * pairs + 2, _GOLDEN))
    u1 = ((a >> 8).float() + 1.0) * 2.0 ** -24   # (0, 1]
    u2 = (b >> 8).float() * 2.0 ** -24           # [0, 1)
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = (2.0 * math.pi) * u2
    z = torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)],
                    dim=-1)
    return z.reshape(batch, n, -1)[..., :dim]


def _geometry(codec) -> tuple[int, int, int]:
    """(window, hop, span) of the codec's MDCT; the frame span must be a
    whole number of hops."""
    cfg = codec.adapter.strategy.config
    window, hop = int(cfg.window_size), int(cfg.hop_size)
    span = 2 * window
    if span % hop:
        raise ValueError(
            f"streaming needs hop | 2*window; got window={window} hop={hop}")
    return window, hop, span


class StreamingEncoder:
    """Chunked audio -> latents, equal to ``AudioCodec.encode``.

    ``push`` takes ``[B, S, C]`` (or mono ``[B, S]``) chunks of any length
    and returns ``[B, n_new, latent_dim]`` for every frame its samples now
    cover (``n_new`` may be 0). ``flush`` zero-pads the rest as the batch
    framing does, so push + flush emit ``num_frames_for_length`` frames.
    """

    def __init__(self, codec):
        self.codec = codec
        self.window, self.hop, self.span = _geometry(codec)
        self.reset()

    def reset(self) -> None:
        self._carry = None        # stream[emitted*hop : consumed]
        self._consumed = 0        # samples pushed
        self._emitted = 0         # frames emitted
        self._last_gains = None

    @property
    def frames_emitted(self) -> int:
        return self._emitted

    @property
    def last_gains(self) -> torch.Tensor | None:
        """``[B, n, 1]`` gains of the frames the last ``push``/``flush``
        emitted (None without ``gain_norm`` or when none was emitted): side
        information the decoder needs."""
        return self._last_gains

    def _empty(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, 0, self.codec.latent_dim),
                           device=self.codec.device)

    def _encode(self, buf: torch.Tensor, frames: int) -> torch.Tensor:
        """Latents of the first ``frames`` frames of ``buf``: the tokenizer
        pads past the buffer for its own trailing frames, and the first
        ``frames`` are the batch framing's."""
        tokens = self.codec.adapter.strategy.tokenize(buf)[:, :frames]
        latents, gains = self.codec._encode_tokens(tokens)
        self._last_gains = gains if self.codec.adapter.gain_norm else None
        return latents

    def push(self, chunk) -> torch.Tensor:
        chunk = self.codec._tensor(chunk, torch.float32)
        buf = (chunk if self._carry is None
               else torch.cat([self._carry, chunk], dim=1))
        total = self._consumed + int(chunk.shape[1])
        n_ready = max(0, (total - self.span) // self.hop + 1)
        n_new = n_ready - self._emitted
        if n_new > 0:
            out = self._encode(buf, n_new)
        else:
            out = self._empty(chunk.shape[0])
            self._last_gains = None
        keep = total - max(n_ready, self._emitted) * self.hop
        # a copy: on the first push ``buf`` is the caller's chunk, which a
        # capture loop may refill in place
        self._carry = buf[:, buf.shape[1] - keep:].clone()
        self._consumed = total
        self._emitted = max(n_ready, self._emitted)
        return out

    def push_bytes(self, chunk, bits: int = 8) -> bytes:
        """``push``, then pack the emitted frames (and their gains) as one
        self-contained MACB packet; empty bytes while the lookahead fills.
        Decode each packet with :meth:`StreamingDecoder.push_bytes`."""
        latents = self.push(chunk)
        if latents.shape[1] == 0:
            return b""
        stream = latent_quant.quantize_latents(latents, bits=bits)
        if self.last_gains is not None:
            stream = dataclasses.replace(stream, gains=self.last_gains)
        return latent_quant.pack_bitstream(stream)

    def flush(self, tail=None) -> torch.Tensor:
        """Emit the trailing zero-padded frames (after an optional final
        chunk ``tail``) and reset the encoder."""
        if self._carry is None and tail is None:
            raise RuntimeError("flush() before any push()")
        parts = [] if self._carry is None else [self._carry]
        if tail is not None:
            parts.append(self.codec._tensor(tail, torch.float32))
            self._consumed += int(parts[-1].shape[1])
        buf = torch.cat(parts, dim=1)
        total, emitted = self._consumed, self._emitted
        self.reset()
        missing = num_frames_for_length(total, self.window, self.hop) - emitted
        if missing <= 0:
            return self._empty(buf.shape[0])
        pad = (missing - 1) * self.hop + self.span - int(buf.shape[1])
        if pad > 0:
            widths = [0, 0] * (buf.ndim - 2) + [0, pad]
            buf = torch.nn.functional.pad(buf, widths)
        return self._encode(buf, missing)


class StreamingDecoder:
    """Chunked latents -> audio, invariant to the chunking.

    Each ``push`` of ``[B, n, latent_dim]`` decodes those frames (``nfe``
    model calls) from the noise of their absolute frame indices, adds the
    carried ``2W - H`` tail and returns the ``n * hop`` samples no later
    frame touches; ``flush`` returns the tail, completing the batch length
    ``(nf - 1) * hop + 2W``. ``noise_fn(start, n, batch, dim)`` replaces
    :func:`frame_noise` when given.
    """

    def __init__(self, codec, seed: int = 0, nfe: int = 1, noise_fn=None):
        self.codec = codec
        self.window, self.hop, self.span = _geometry(codec)
        self.seed = int(seed)
        self.nfe = int(nfe)
        self.noise_fn = noise_fn
        self.reset()

    def reset(self) -> None:
        self._tail = None         # [B, span - hop, ...] overlap-add carry
        self._frame_index = 0     # absolute index of the next frame
        self._batch = None        # learned from the first push

    @property
    def frames_decoded(self) -> int:
        return self._frame_index

    def _empty(self, batch: int) -> torch.Tensor:
        """A zero-sample emission with the output's rank and channels."""
        ch = self.codec._channels
        shape = (batch, 0) if ch == 1 else (batch, 0, ch)
        return torch.zeros(shape, device=self.codec.device)

    def _noise(self, n: int, batch: int) -> torch.Tensor:
        dim = self.codec.noise_dim
        if self.noise_fn is None:
            noise = frame_noise(self.seed, self._frame_index, n, batch, dim,
                                device=self.codec.device)
        else:
            noise = self.codec._tensor(self.noise_fn(self._frame_index, n,
                                                     batch, dim))
        return noise.reshape(batch * n, dim)

    def push(self, latents, gains=None) -> torch.Tensor:
        latents = self.codec._tensor(latents)
        batch, n = int(latents.shape[0]), int(latents.shape[1])
        self._batch = batch
        if n == 0:
            return self._empty(batch)
        # decode() overlap-adds within the chunk, giving the
        # (n-1)*hop + 2W segment whose sum across chunks the tail carries;
        # gains scale tokens before the overlap-add, so chunking does not
        # change them either
        seg = self.codec.decode(latents, nfe=self.nfe, gains=gains,
                                noise=self._noise(n, batch))
        carry = self.span - self.hop
        if self._tail is not None:
            seg[:, :carry] += self._tail
        emit = n * self.hop
        self._tail = seg[:, emit:]
        self._frame_index += n
        return seg[:, :emit]

    def push_bytes(self, packet: bytes) -> torch.Tensor:
        """Decode one packet of :meth:`StreamingEncoder.push_bytes`; an
        empty packet emits zero samples (batch 1 before any data packet)."""
        if not packet:
            return self._empty(self._batch or 1)
        stream = latent_quant.unpack_bitstream(packet).to(self.codec.device)
        return self.push(latent_quant.dequantize_latents(stream),
                         gains=stream.gains)

    def flush(self) -> torch.Tensor:
        """Emit the final ``2W - H`` overlap-add tail; resets the decoder."""
        if self._tail is None:
            raise RuntimeError("flush() before any push()")
        tail = self._tail
        self.reset()
        return tail


class StreamingCodec:
    """Full-duplex chunked round trip: audio in, reconstructed audio out,
    ``latency_samples = 2W - H`` behind the input."""

    def __init__(self, codec, seed: int = 0, nfe: int = 1, noise_fn=None):
        self.encoder = StreamingEncoder(codec)
        self.decoder = StreamingDecoder(codec, seed=seed, nfe=nfe,
                                        noise_fn=noise_fn)

    @property
    def latency_samples(self) -> int:
        return self.encoder.span - self.encoder.hop

    def push(self, chunk) -> torch.Tensor:
        latents = self.encoder.push(chunk)
        return self.decoder.push(latents, gains=self.encoder.last_gains)

    def flush(self, tail=None) -> torch.Tensor:
        latents = self.encoder.flush(tail)
        parts = [self.decoder.push(latents, gains=self.encoder.last_gains),
                 self.decoder.flush()]
        return torch.cat(parts, dim=1)

    def reset(self) -> None:
        self.encoder.reset()
        self.decoder.reset()
