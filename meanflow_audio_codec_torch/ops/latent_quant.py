"""Latent bitstream: scalar-quantized codec latents and the MACB format.

Counterpart of ``meanflow_audio_codec_tpu/ops/latent_quant.py``, with the
same container bytes, so a stream either package writes reads in the other:

- **MACB v1** (:func:`quantize_latents`): symmetric per-frame codes of 4, 8
  or 16 bits, scale = per-frame peak / qmax;
- **MACB v2** (:func:`quantize_latents_ecsq`): a per-clip per-dim mean
  (8-bit codes + one scale per clip) subtracted, then a uniform grid of
  ``step_frac`` x the per-frame residual standard deviation, int8 codes;
- :class:`LatentQAT` trains through either grid (straight-through or
  uniform noise of one step);
- 4- and 8-bit codes are rANS-coded (``ops/entropy.py``) when that is
  smaller; a flag bit carries 8-bit log-domain per-frame gains of
  gain-normalised codecs.

The quantizers run in torch on the latents' device; the codes leave the
device once, in :func:`pack_bitstream`. Both packages round half to even
(``jnp.round``, ``torch.round``), divide by a constant as a product with
its float32 reciprocal (as XLA compiles it) and take the population
standard deviation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from meanflow_audio_codec_torch.ops import entropy as coder

#: storage dtype per code width; 4-bit codes ride int8 (the rANS coder
#: recovers their entropy)
_INT_DTYPES = {4: torch.int8, 8: torch.int8, 16: torch.int16}
_NP_DTYPES = {4: np.int8, 8: np.int8, 16: np.int16}


@dataclass(frozen=True)
class LatentBitstream:
    """Quantized latents: integer codes + per-frame float32 scales.

    ``codes`` ``[B, nf, D]`` int8/int16, ``scale`` ``[B, nf, 1]`` float32;
    ``qbits`` is the quantizer width when narrower than the storage dtype
    (0: dtype-implied). ECSQ streams (v2) add ``mean_codes``
    ``[B, 1, D]`` int8 and ``mean_scale`` ``[B, 1, 1]``; gain-normalised
    codecs add ``gains`` ``[B, nf, 1]``.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    qbits: int = 0
    mean_codes: torch.Tensor | None = None
    mean_scale: torch.Tensor | None = None
    gains: torch.Tensor | None = None

    @property
    def bits(self) -> int:
        return self.qbits or self.codes.element_size() * 8

    def to(self, device: torch.device | str) -> "LatentBitstream":
        """This stream with every tensor on ``device``."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


#: 8-bit log-gain grid: log2(gain) uniformly quantized over [-12, 4]
_GAIN_LOG2_LO, _GAIN_LOG2_HI = -12.0, 4.0


def quantize_gains(gains) -> np.ndarray:
    """[B, nf, 1] float gains -> uint8 log-domain codes (numpy)."""
    g = np.maximum(np.asarray(gains, dtype=np.float32), 2.0 ** _GAIN_LOG2_LO)
    t = (np.log2(g) - _GAIN_LOG2_LO) / (_GAIN_LOG2_HI - _GAIN_LOG2_LO)
    return np.clip(np.round(t * 255.0), 0, 255).astype(np.uint8)


def dequantize_gains(codes) -> np.ndarray:
    """uint8 log-gain codes -> float32 gains (numpy)."""
    t = np.asarray(codes, dtype=np.float32) / 255.0
    return np.exp2(_GAIN_LOG2_LO
                   + t * (_GAIN_LOG2_HI - _GAIN_LOG2_LO)).astype(np.float32)


def quantize_latents(latents: torch.Tensor, bits: int = 8) -> LatentBitstream:
    """[B, nf, D] float latents -> symmetric per-frame scalar codes."""
    if bits not in _INT_DTYPES:
        raise ValueError(f"bits must be one of {sorted(_INT_DTYPES)}")
    qmax = float(2 ** (bits - 1) - 1)
    latents = latents.float()
    peak = latents.abs().amax(dim=-1, keepdim=True)
    # XLA turns the JAX package's division by the constant qmax into a
    # product with its float32 reciprocal; so does this, bit for bit
    scale = peak.clamp_min(1e-12) * (1.0 / qmax)
    codes = torch.round(latents / scale).clamp(-qmax, qmax)
    dtype = _INT_DTYPES[bits]
    qbits = bits if bits < dtype.itemsize * 8 else 0
    return LatentBitstream(codes.to(dtype), scale, qbits=qbits)


def quantize_latents_ecsq(latents: torch.Tensor,
                          step_frac: float = 0.5) -> LatentBitstream:
    """Mean-removed entropy-constrained scalar quantization (MACB v2).

    Subtract a per-clip per-dim mean (itself 8-bit quantized), then
    quantize the residual on a grid of ``step_frac`` x the per-frame
    residual standard deviation, int8 codes. ``[B, nf, D]`` (per-clip
    means) or ``[nf, D]`` (one stream).
    """
    z = latents.float()
    mean = z.mean(dim=-2, keepdim=True)
    mean_scale = (mean.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
                  * (1.0 / 127.0))
    mean_codes = torch.round(mean / mean_scale).clamp(-127, 127)
    resid = z - mean_codes * mean_scale
    step = (resid.std(dim=-1, keepdim=True, correction=0).clamp_min(1e-12)
            * step_frac)
    codes = torch.round(resid / step).clamp(-127, 127)
    return LatentBitstream(codes.to(torch.int8), step,
                           mean_codes=mean_codes.to(torch.int8),
                           mean_scale=mean_scale)


def dequantize_latents(bitstream: LatentBitstream) -> torch.Tensor:
    """Codes + scales (+ mean vector for ECSQ streams) -> float32 latents."""
    out = bitstream.codes.float() * bitstream.scale
    if bitstream.mean_codes is not None:
        out = out + bitstream.mean_codes.float() * bitstream.mean_scale
    return out


@dataclass(frozen=True)
class LatentQAT:
    """Quantization-aware training transform for codec latents, applied to
    the encoder output inside the training objective.

    ``mode="ste"``: the forward is exactly the eval round trip
    (:func:`quantize_latents_ecsq` / :func:`quantize_latents` ->
    :func:`dequantize_latents`), the backward the identity.
    ``mode="noise"``: ``z + u * sg(step(z))`` with ``u ~ U(-0.5, 0.5)`` of
    the latents' shape, one quantizer step per frame. The JAX package draws
    ``u`` from ``fold_in(key, 0x9A7)``; here it is passed in or drawn by
    :meth:`draw` from a ``torch.Generator``.

    ``step_frac`` selects the ECSQ grid (MACB v2), ``bits`` the fixed-width
    grid (MACB v1); exactly one must be set.
    """

    mode: str = "ste"
    step_frac: float | None = None
    bits: int | None = None

    def __post_init__(self):
        if (self.step_frac is None) == (self.bits is None):
            raise ValueError("set exactly one of step_frac (ECSQ) or "
                             "bits (fixed-width)")
        if self.mode not in ("ste", "noise"):
            raise ValueError(f"mode must be 'ste' or 'noise', got {self.mode!r}")

    def _roundtrip(self, z: torch.Tensor) -> torch.Tensor:
        if self.step_frac is not None:
            return dequantize_latents(
                quantize_latents_ecsq(z, step_frac=self.step_frac))
        return dequantize_latents(quantize_latents(z, bits=self.bits))

    def _step(self, z: torch.Tensor) -> torch.Tensor:
        """One quantizer step per frame (the uniform noise's amplitude)."""
        if self.step_frac is not None:
            mean = z.mean(dim=-2, keepdim=True)
            return ((z - mean).std(dim=-1, keepdim=True, correction=0)
                    .clamp_min(1e-12) * self.step_frac)
        qmax = float(2 ** (self.bits - 1) - 1)
        return z.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / qmax

    def draw(self, shape, generator: torch.Generator | None = None,
             device: torch.device | str | None = None) -> torch.Tensor | None:
        """The uniform draw ``u`` of the noise mode (None for "ste")."""
        if self.mode != "noise":
            return None
        return torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=device) - 0.5

    def __call__(self, latents: torch.Tensor,
                 noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """The transformed latents, in ``latents``' dtype; ``noise`` is the
        noise mode's ``u`` (drawn from ``generator`` when absent)."""
        z = latents.float()
        with torch.no_grad():
            if self.mode == "ste":
                shift = self._roundtrip(z) - z
            else:
                if noise is None:
                    noise = self.draw(z.shape, generator, z.device)
                step = self._step(z)
        if self.mode == "ste":
            out = z + shift
        else:
            out = z + noise.to(z.device, torch.float32) * step
        return out.to(latents.dtype)


def bitstream_kbps(latent_dim: int, frames_per_second: float,
                   bits: int = 8) -> float:
    """Stored bitrate: codes plus one float32 scale per frame."""
    return frames_per_second * (latent_dim * bits + 32) / 1000.0


# ============================================================================
# Serialization: LatentBitstream <-> bytes
# ============================================================================

_MAGIC = b"MACB"
_FLAG_ENTROPY = 1
#: a uint8 log-gain section ([B*nf] bytes) follows the scales; readers
#: reject unknown flags rather than guess the layout
_FLAG_GAINS = 2


def _host(value, dtype) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=dtype)


def pack_bitstream(bitstream: LatentBitstream,
                   entropy: bool | None = None) -> bytes:
    """Serialize to the stored bytes.

    4- and 8-bit codes go through the rANS coder unless ``entropy=False``;
    with ``entropy=None`` (auto) raw codes are stored when the coded stream
    would not be smaller (the 512-byte table loses on tiny streams). Scales
    are raw float32. The header records the path taken.
    """
    codes = _host(bitstream.codes, _NP_DTYPES[bitstream.bits])
    scale = _host(bitstream.scale, np.float32)
    if codes.ndim == 2:  # one stream [nf, D]
        codes, scale = codes[None], scale[None]
    b, nf, d = codes.shape
    bits = bitstream.bits
    flags = 0
    if bits in (4, 8) and entropy is not False:
        payload = coder.entropy_encode(codes)
        flags = _FLAG_ENTROPY
        if entropy is None and len(payload) >= codes.size:
            payload, flags = codes.tobytes(), 0
    else:
        if entropy is True:
            raise ValueError("entropy coding supports int8-stored codes "
                             "(4/8-bit) only")
        payload = codes.tobytes()
    # version 2 when a mean vector rides along (ECSQ streams)
    version = 1 if bitstream.mean_codes is None else 2
    gain_section = b""
    if bitstream.gains is not None:
        flags |= _FLAG_GAINS
        gain_section = quantize_gains(_host(bitstream.gains,
                                            np.float32)).tobytes()
    header = (_MAGIC + bytes([version, bits, flags, 0])
              + np.asarray([b, nf, d], dtype="<u4").tobytes())
    mean_section = b""
    if version == 2:
        mean_scale = _host(bitstream.mean_scale, np.float32)
        mean_codes = _host(bitstream.mean_codes, np.int8)
        mean_section = (mean_scale.reshape(-1).astype("<f4").tobytes()
                        + mean_codes.tobytes())
    sizes = np.asarray([len(payload)], dtype="<u8").tobytes()
    return (header + mean_section + scale.astype("<f4").tobytes()
            + gain_section + sizes + payload)


def _tensor(array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(array))  # a writable copy


def unpack_bitstream(data: bytes) -> LatentBitstream:
    """Inverse of :func:`pack_bitstream`: CPU tensors, codes and scales
    exactly as packed."""
    if data[:4] != _MAGIC:
        raise ValueError("not a MACB latent bitstream")
    version, bits, flags, _ = data[4:8]
    if version not in (1, 2):
        raise ValueError(f"unsupported bitstream version {version}")
    if flags & ~(_FLAG_ENTROPY | _FLAG_GAINS):
        raise ValueError(f"unknown bitstream flags 0x{flags:02x} — "
                         "refusing to guess the section layout")
    b, nf, d = (int(x) for x in np.frombuffer(data[8:20], dtype="<u4"))
    off = 20
    mean_codes = mean_scale = None
    if version == 2:
        mean_scale = np.frombuffer(
            data[off:off + 4 * b], dtype="<f4").reshape(b, 1, 1)
        off += 4 * b
        mean_codes = np.frombuffer(
            data[off:off + b * d], dtype=np.int8).reshape(b, 1, d)
        off += b * d
    scale = np.frombuffer(data[off:off + 4 * b * nf],
                          dtype="<f4").reshape(b, nf, 1)
    off += 4 * b * nf
    gains = None
    if flags & _FLAG_GAINS:
        gains = dequantize_gains(np.frombuffer(
            data[off:off + b * nf], dtype=np.uint8).reshape(b, nf, 1))
        off += b * nf
    (payload_len,) = np.frombuffer(data[off:off + 8], dtype="<u8")
    off += 8
    payload = data[off:off + int(payload_len)]
    n = b * nf * d
    if flags & _FLAG_ENTROPY:
        codes = coder.entropy_decode(payload, n)
    else:
        codes = np.frombuffer(payload, dtype=_NP_DTYPES[bits], count=n)
    return LatentBitstream(
        _tensor(codes.reshape(b, nf, d)), _tensor(scale),
        qbits=bits if bits == 4 else 0,
        mean_codes=None if mean_codes is None else _tensor(mean_codes),
        mean_scale=None if mean_scale is None else _tensor(mean_scale),
        gains=None if gains is None else _tensor(gains))


def describe_bitstream(data: bytes) -> dict:
    """Header summary of a packed stream (what ``codec_cli info`` prints)."""
    if data[:4] != _MAGIC:
        raise ValueError("not a MACB latent bitstream")
    version, bits, flags, _ = data[4:8]
    b, nf, d = (int(x) for x in np.frombuffer(data[8:20], dtype="<u4"))
    return {"version": version, "bits": bits,
            "coding": "rANS" if flags & _FLAG_ENTROPY else "raw",
            "quantizer": "ecsq+mean" if version == 2 else "symmetric",
            "gain_shape": bool(flags & _FLAG_GAINS),
            "batch": b, "n_frames": nf, "latent_dim": d,
            "total_bytes": len(data)}
