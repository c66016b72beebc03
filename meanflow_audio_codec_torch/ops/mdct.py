"""MDCT / IMDCT: configuration, constants and the plain PyTorch versions.

Counterpart of ``meanflow_audio_codec_tpu/ops/mdct.py``. ``mdct`` and
``imdct`` take the direct path (framing + one matmul against the windowed
basis; ``mdct_direct``/``imdct_direct``) below the config's
``use_fft_threshold`` (``DEFAULT_FFT_THRESHOLD``, W 4096, the JAX package's
default) and the O(W log W) FFT path (``mdct_fft``/``imdct_fft``, on
``torch.fft``: cuFFT on the card) from it on, as the JAX package's do off
the TPU. Each takes the JAX package's keyword form (``window_size``,
``hop_size``, for ``mdct``/``imdct`` also ``use_fft_threshold`` and
``config``) or an :class:`MDCTConfig` in place of ``window_size``. They
are the plain versions of the two CUDA kernels
(``ops/mdct_cuda.py``, ``ops/imdct_cuda.py``): the CPU runs them, the tests
hold them against the JAX package, and the chip check holds the kernels
against them. On the card the tokenizer calls the kernels instead, at every
W (as the JAX tokenizer keeps its Pallas kernels on the TPU).

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
DEFAULT_FFT_THRESHOLD = 4096  # the direct path below this W, the FFT from it
PRINCEN_BRADLEY_OFFSET = 0.5
IMDCT_SCALING_FACTOR = 2.0


@dataclass(frozen=True)
class MDCTConfig:
    """Static MDCT parameters: W coefficients per frame of length 2W,
    frames ``hop_size`` apart (default W // 2); the plain ``mdct``/``imdct``
    take the FFT path from W = ``use_fft_threshold`` on.

    ``use_fft_threshold`` comes after ``normalize`` (the JAX package puts it
    before), so the port's positional ``MDCTConfig(W, hop, normalize)``
    keeps its meaning; pass it by keyword. The CUDA kernels take every W,
    whatever the threshold."""

    window_size: int = DEFAULT_WINDOW_SIZE
    hop_size: int | None = None
    normalize: bool = False
    use_fft_threshold: int = DEFAULT_FFT_THRESHOLD

    def __post_init__(self) -> None:
        if self.window_size <= 0:
            raise ValueError(
                f"window_size must be positive, got {self.window_size}")
        if self.hop_size is not None and self.hop_size <= 0:
            raise ValueError(f"hop_size must be positive, got {self.hop_size}")
        if self.use_fft_threshold <= 0:
            raise ValueError("use_fft_threshold must be positive, got "
                             f"{self.use_fft_threshold}")
        if self.hop_size is None:
            object.__setattr__(self, "hop_size", self.window_size // 2)


# ============================================================================
# Constants: built in float64 with numpy, stored float32
# ============================================================================


def sine_window(window_length: int) -> torch.Tensor:
    """Princen-Bradley sine window ``w[n] = sin(pi (n + 1/2) / N)``, float32,
    computed in float32 as the JAX package's ``sine_window``."""
    if window_length <= 0:
        raise ValueError(f"Window length must be positive, got {window_length}")
    n = torch.arange(window_length, dtype=torch.float32)
    return torch.sin(torch.pi * (n + PRINCEN_BRADLEY_OFFSET) / window_length)


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


@functools.lru_cache(maxsize=32)
def _fft_twiddles_np(window_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(pre[2W], post[W]) complex64 twiddles of the 2W-point FFT route:
    ``X[k] = Re(FFT_2W(x w pre)[k] post[k])`` with ``pre[n] =
    exp(-i pi n / 2W)`` and ``post[k] = exp(-i pi (k + 1/2)(1/(2W) + 1/2))``.
    """
    two_w = 2 * window_size
    n = np.arange(two_w, dtype=np.float64)
    k = np.arange(window_size, dtype=np.float64)
    pre = np.exp(-1j * np.pi * n / two_w)
    post = np.exp(-1j * np.pi * (k + PRINCEN_BRADLEY_OFFSET)
                  * (1.0 / two_w + 0.5))
    return pre.astype(np.complex64), post.astype(np.complex64)


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


def _as_config(config: MDCTConfig | int, hop_size: int | None = None,
               use_fft_threshold: int = DEFAULT_FFT_THRESHOLD) -> MDCTConfig:
    """``config`` itself, or the config of window size ``config``,
    ``hop_size`` and ``use_fft_threshold`` (the JAX package's keyword form;
    no normalisation, as there)."""
    if isinstance(config, MDCTConfig):
        return config
    return MDCTConfig(window_size=config, hop_size=hop_size,
                      use_fft_threshold=use_fft_threshold)


def mdct_direct(x: torch.Tensor, window_size: MDCTConfig | int,
                hop_size: int | None = None) -> torch.Tensor:
    """Forward MDCT, ``(..., T) -> (..., n_frames, W)``: framing + matmul."""
    config = _as_config(window_size, hop_size)
    if x.ndim == 0:
        raise ValueError("Input must have at least 1 dimension")
    w, hop = config.window_size, config.hop_size
    x2d, nf, original_shape = _prepare_signal(x.float(), w, hop)
    frames = _frame(x2d, nf, w, hop)
    coeffs = torch.matmul(frames, windowed_basis(w, x.device))
    return coeffs.reshape(original_shape[:-1] + (nf, w)).to(x.dtype)


def _twiddles(window_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    pre, post = _fft_twiddles_np(window_size)
    return (torch.tensor(pre, device=device), torch.tensor(post, device=device))


def mdct_fft(x: torch.Tensor, window_size: MDCTConfig | int,
             hop_size: int | None = None) -> torch.Tensor:
    """Forward MDCT by a 2W-point complex FFT of the windowed, pre-twiddled
    frames; the same coefficients as :func:`mdct_direct`."""
    config = _as_config(window_size, hop_size)
    if x.ndim == 0:
        raise ValueError("Input must have at least 1 dimension")
    w, hop = config.window_size, config.hop_size
    x2d, nf, original_shape = _prepare_signal(x.float(), w, hop)
    frames = _frame(x2d, nf, w, hop)
    window = torch.tensor(_window_np(w), device=x.device)
    pre, post = _twiddles(w, x.device)
    spectrum = torch.fft.fft((frames * window).to(torch.complex64) * pre,
                             dim=-1)[..., :w]
    coeffs = (spectrum * post).real
    return coeffs.reshape(original_shape[:-1] + (nf, w)).to(x.dtype)


def _use_fft(config: MDCTConfig) -> bool:
    return config.window_size >= config.use_fft_threshold


def mdct(x: torch.Tensor, window_size: MDCTConfig | int = DEFAULT_WINDOW_SIZE,
         hop_size: int | None = None,
         use_fft_threshold: int = DEFAULT_FFT_THRESHOLD,
         config: MDCTConfig | None = None) -> torch.Tensor:
    """Forward MDCT, ``(..., T) -> (..., n_frames, W)``: the direct path
    below the config's ``use_fft_threshold``, the FFT path from it on.
    ``mdct(x, config)`` and the JAX package's keyword form both work."""
    if config is None:
        config = _as_config(window_size, hop_size, use_fft_threshold)
    return (mdct_fft if _use_fft(config) else mdct_direct)(x, config)


def imdct_scale(config: MDCTConfig) -> float:
    """The factor on ``X @ WB^T``: 2/W, times hop/W when normalizing."""
    scale = IMDCT_SCALING_FACTOR / config.window_size
    if config.normalize:
        scale *= config.hop_size / config.window_size
    return scale


def _coeff_rows(X: torch.Tensor) -> torch.Tensor:
    if X.ndim < 2:
        raise ValueError(
            f"Input must have at least 2 dims (n_frames, window), got {X.shape}")
    return X.reshape(-1, X.shape[-2], X.shape[-1]).float()


def imdct_direct(X: torch.Tensor, window_size: MDCTConfig | int,
                 hop_size: int | None = None) -> torch.Tensor:
    """Inverse MDCT, ``(..., n_frames, W) -> (..., (nf-1)*hop + 2W)``:
    matmul + overlap-add."""
    config = _as_config(window_size, hop_size)
    x3d = _coeff_rows(X)
    w, hop = config.window_size, config.hop_size
    out_len = output_length(x3d.shape[1], w, hop)
    frames = imdct_scale(config) * torch.matmul(
        x3d, windowed_basis(w, X.device, transposed=True))
    signal = _overlap_add(frames, hop, out_len)
    return signal.reshape(X.shape[:-2] + (out_len,)).to(X.dtype)


def imdct_fft(X: torch.Tensor, window_size: MDCTConfig | int,
              hop_size: int | None = None) -> torch.Tensor:
    """Inverse MDCT by a 2W-point inverse FFT: ``y[n] = scale Re(conj(pre[n])
    ifft(conj(post) X, zero-padded to 2W)[n]) w[n]``, overlap-added; the
    ``2W`` of the ifft's normalisation folds into the scale."""
    config = _as_config(window_size, hop_size)
    x3d = _coeff_rows(X)
    w, hop = config.window_size, config.hop_size
    out_len = output_length(x3d.shape[1], w, hop)
    window = torch.tensor(_window_np(w), device=X.device)
    pre, post = _twiddles(w, X.device)
    a = torch.nn.functional.pad(x3d.to(torch.complex64) * post.conj(), (0, w))
    y = torch.fft.ifft(a, dim=-1) * (imdct_scale(config) * 2 * w)
    frames = (y * pre.conj()).real * window
    signal = _overlap_add(frames, hop, out_len)
    return signal.reshape(X.shape[:-2] + (out_len,)).to(X.dtype)


def imdct(X: torch.Tensor, window_size: MDCTConfig | int = DEFAULT_WINDOW_SIZE,
          hop_size: int | None = None,
          use_fft_threshold: int = DEFAULT_FFT_THRESHOLD,
          config: MDCTConfig | None = None) -> torch.Tensor:
    """Inverse MDCT, ``(..., n_frames, W) -> (..., (nf-1)*hop + 2W)``: the
    direct path below the config's ``use_fft_threshold``, the FFT path from
    it on. ``imdct(X, config)`` and the JAX package's keyword form both
    work."""
    if config is None:
        config = _as_config(window_size, hop_size, use_fft_threshold)
    return (imdct_fft if _use_fft(config) else imdct_direct)(X, config)
