"""MDCT / IMDCT: configuration, constants and the plain PyTorch versions.

Counterpart of ``meanflow_audio_codec_tpu/ops/mdct.py`` (direct path). The
functions here are the plain versions of the two CUDA kernels
(``ops/mdct_cuda.py``, ``ops/imdct_cuda.py``): the CPU runs them, the tests
hold them against the JAX package, and the chip check holds the kernels
against them. On the card the tokenizer calls the kernels instead.

Transform convention (identical to the JAX package):

  window  w[n]   = sin(pi (n + 1/2) / (2W)),                 n in [0, 2W)
  forward X[k]   = sum_n x_f[n] w[n] cos(pi/W (n + W/2 + 1/2)(k + 1/2))
  inverse y[n]   = (2/W) sum_k X[k] cos(...) * w[n], overlap-added at hop
  frames  nf     = 1 if T < W else (T - W)//hop + 1, signal zero-padded to
                   (nf-1) hop + 2W; reconstruction length (nf-1) hop + 2W.

With ``normalize=False`` a round trip reconstructs W/hop times the input
(2x at the default hop W/2); ``normalize=True`` divides that gain out.
All arithmetic is float32 whatever the input dtype.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_WINDOW_SIZE = 576
PRINCEN_BRADLEY_OFFSET = 0.5
IMDCT_SCALING_FACTOR = 2.0


@dataclass(frozen=True)
class MDCTConfig:
    """Static MDCT parameters: W coefficients per frame of length 2W,
    frames ``hop_size`` apart (default W // 2)."""

    window_size: int = DEFAULT_WINDOW_SIZE
    hop_size: int | None = None
    normalize: bool = False

    def __post_init__(self) -> None:
        if self.window_size <= 0:
            raise ValueError(
                f"window_size must be positive, got {self.window_size}")
        if self.hop_size is not None and self.hop_size <= 0:
            raise ValueError(f"hop_size must be positive, got {self.hop_size}")
        if self.hop_size is None:
            object.__setattr__(self, "hop_size", self.window_size // 2)


# ============================================================================
# Constants: built in float64 with numpy, stored float32
# ============================================================================


@functools.lru_cache(maxsize=32)
def _window_np(window_size: int) -> np.ndarray:
    n = np.arange(2 * window_size, dtype=np.float64)
    w = np.sin(np.pi * (n + PRINCEN_BRADLEY_OFFSET) / (2 * window_size))
    w = w.astype(np.float32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=32)
def _windowed_basis_np(window_size: int) -> np.ndarray:
    """[2W, W] cosine basis with the window folded in: frames @ WB = MDCT."""
    w = _window_np(window_size).astype(np.float64)
    n = np.arange(2 * window_size, dtype=np.float64)[:, None]
    k = np.arange(window_size, dtype=np.float64)[None, :]
    basis = np.cos(np.pi / window_size
                   * (n + window_size / 2 + PRINCEN_BRADLEY_OFFSET)
                   * (k + PRINCEN_BRADLEY_OFFSET))
    wb = (w[:, None] * basis).astype(np.float32)
    wb.setflags(write=False)
    return wb


@functools.lru_cache(maxsize=16)
def windowed_basis(window_size: int, device: torch.device | str = "cpu",
                   transposed: bool = False) -> torch.Tensor:
    """The [2W, W] windowed basis (or its [W, 2W] transpose) on ``device``.

    Built once per (W, device, layout) and kept there: 2 MB at W=512.
    """
    wb = _windowed_basis_np(window_size)
    if transposed:
        wb = wb.T
    # the kernels index it as a dense row-major array
    return torch.tensor(np.ascontiguousarray(wb), device=device)


# ============================================================================
# Shape bookkeeping
# ============================================================================


def num_frames_for_length(time_length: int, window_size: int, hop: int) -> int:
    """Frame count convention shared with the JAX package."""
    if time_length < window_size:
        return 1
    return (time_length - window_size) // hop + 1


def output_length(num_frames: int, window_size: int, hop: int) -> int:
    """Reconstruction length for a given frame count."""
    return (num_frames - 1) * hop + 2 * window_size


def _prepare_signal(x: torch.Tensor, window_size: int, hop: int):
    """Flatten leading dims and zero-pad to the framed length.

    Returns (x2d [R, T_pad], num_frames, original_shape).
    """
    original_shape = x.shape
    x2d = x.reshape(-1, original_shape[-1])
    time_length = x2d.shape[1]
    nf = num_frames_for_length(time_length, window_size, hop)
    required = output_length(nf, window_size, hop)
    if time_length < required:
        x2d = F.pad(x2d, (0, required - time_length))
    return x2d, nf, original_shape


def _frame(x2d: torch.Tensor, num_frames: int, window_size: int,
           hop: int) -> torch.Tensor:
    """[R, T] -> [R, nf, 2W] by an index gather (row f = f*hop + [0, 2W))."""
    starts = torch.arange(num_frames, device=x2d.device)[:, None] * hop
    offsets = torch.arange(2 * window_size, device=x2d.device)[None, :]
    return x2d[:, starts + offsets]


def _overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """[R, nf, L] frames -> [R, out_len] by k = ceil(L/hop) shifted adds."""
    rows, nf, frame_len = frames.shape
    k = -(-frame_len // hop)
    pad = k * hop - frame_len
    if pad:
        frames = F.pad(frames, (0, pad))
    chunks = frames.reshape(rows, nf, k, hop)
    out = frames.new_zeros(rows, nf - 1 + k, hop)
    for j in range(k):
        out[:, j:j + nf] += chunks[:, :, j]
    return out.reshape(rows, -1)[:, :out_len]


# ============================================================================
# Plain versions of the two kernels
# ============================================================================


def mdct(x: torch.Tensor, config: MDCTConfig) -> torch.Tensor:
    """Forward MDCT, ``(..., T) -> (..., n_frames, W)``: framing + matmul."""
    if x.ndim == 0:
        raise ValueError("Input must have at least 1 dimension")
    w, hop = config.window_size, config.hop_size
    x2d, nf, original_shape = _prepare_signal(x.float(), w, hop)
    frames = _frame(x2d, nf, w, hop)
    coeffs = torch.matmul(frames, windowed_basis(w, x.device))
    return coeffs.reshape(original_shape[:-1] + (nf, w)).to(x.dtype)


def imdct_scale(config: MDCTConfig) -> float:
    """The factor on ``X @ WB^T``: 2/W, times hop/W when normalizing."""
    scale = IMDCT_SCALING_FACTOR / config.window_size
    if config.normalize:
        scale *= config.hop_size / config.window_size
    return scale


def imdct(X: torch.Tensor, config: MDCTConfig) -> torch.Tensor:
    """Inverse MDCT, ``(..., n_frames, W) -> (..., (nf-1)*hop + 2W)``:
    matmul + overlap-add."""
    if X.ndim < 2:
        raise ValueError(
            f"Input must have at least 2 dims (n_frames, window), got {X.shape}")
    w, hop = config.window_size, config.hop_size
    original_shape = X.shape
    x3d = X.reshape(-1, original_shape[-2], original_shape[-1]).float()
    nf = x3d.shape[1]
    out_len = output_length(nf, w, hop)
    frames = imdct_scale(config) * torch.matmul(
        x3d, windowed_basis(w, X.device, transposed=True))
    signal = _overlap_add(frames, hop, out_len)
    return signal.reshape(original_shape[:-2] + (out_len,)).to(X.dtype)
