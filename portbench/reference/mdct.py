"""Plain float32 MDCT and inverse MDCT, written down from their definition.

Window ``w[n] = sin(pi (n + 1/2) / 2W)`` over frames of 2W samples, ``hop``
apart; coefficient ``k`` of a frame is ``sum_n x[n] w[n] cos(pi/W (n + W/2
+ 1/2)(k + 1/2))``. The inverse scales by ``2 / W``, windows again and
overlap-adds. Frames: ``nf = (T - W) // hop + 1`` (one frame when T < W), the
signal zero-padded to ``(nf - 1) hop + 2W``. Multichannel audio ``[B, T,
C]`` becomes tokens ``[B, nf, C*W]``, channel-major along the coefficients.

Imports nothing of the program under test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _basis_np(window: int) -> np.ndarray:
    n = np.arange(2 * window, dtype=np.float64)[:, None]
    k = np.arange(window, dtype=np.float64)[None, :]
    w = np.sin(np.pi * (n + 0.5) / (2 * window))
    cos = np.cos(np.pi / window * (n + window / 2 + 0.5) * (k + 0.5))
    return (w * cos).astype(np.float32)


def basis(window: int, device) -> torch.Tensor:
    """The ``[2W, W]`` windowed cosine basis, float32."""
    return torch.from_numpy(_basis_np(window)).to(device)


def num_frames(length: int, window: int, hop: int) -> int:
    return 1 if length < window else (length - window) // hop + 1


def out_length(frames: int, window: int, hop: int) -> int:
    return (frames - 1) * hop + 2 * window


def mdct(x: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """``[R, T]`` -> ``[R, nf, W]``."""
    x = x.float()
    nf = num_frames(x.shape[-1], window, hop)
    need = out_length(nf, window, hop)
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    frames = x.unfold(-1, 2 * window, hop)[:, :nf]
    return frames @ basis(window, x.device)


def imdct(coeffs: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """``[R, nf, W]`` -> ``[R, (nf - 1) hop + 2W]``."""
    rows, nf, _ = coeffs.shape
    frames = (2.0 / window) * (coeffs.float() @ basis(window, coeffs.device).T)
    length = out_length(nf, window, hop)
    # F.fold sums the overlapping frames, given as [R, 2W, nf] columns
    out = F.fold(frames.transpose(1, 2), output_size=(1, length),
                 kernel_size=(1, 2 * window), stride=(1, hop))
    return out.reshape(rows, length)


def tokenize(audio: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """``[B, T, C]`` audio -> ``[B, nf, C*W]`` tokens."""
    b, _, c = audio.shape
    coeffs = mdct(audio.movedim(-1, 1).reshape(b * c, -1), window, hop)
    nf = coeffs.shape[1]
    return coeffs.reshape(b, c, nf, window).movedim(1, 2).reshape(b, nf, c * window)


def detokenize(tokens: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """``[B, nf, C*W]`` tokens -> ``[B, (nf - 1) hop + 2W, C]`` audio."""
    b, nf, dim = tokens.shape
    c = dim // window
    per_channel = tokens.reshape(b, nf, c, window).movedim(2, 1)
    audio = imdct(per_channel.reshape(b * c, nf, window), window, hop)
    return audio.reshape(b, c, -1).movedim(1, -1)
