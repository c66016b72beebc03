"""Forward MDCT through the hand-written CUDA kernel ``csrc/mdct.cu``.

Counterpart of ``meanflow_audio_codec_tpu/ops/mdct_pallas.py``. A CPU
tensor goes to the plain version (``ops/mdct.py``); a CUDA tensor goes to the
kernel, or the wrapper raises. ``launches`` counts kernel launches. The kernel
tiles all rows' frame slots as one GEMM on the IMDCT's tile core
(``csrc/mdct.cu``), so its shared memory does not depend on W, hop or the
signal length.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from meanflow_audio_codec_torch.ops import _build
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    mdct,
    num_frames_for_length,
    windowed_basis,
)

#: kernel launches since the count was last set to 0
launches = 0

_MAX_GRID_Y = 65535
# a block's output tile: frame slots x coefficients (kBM, kBN in tile_core.cuh)
_SLOT_TILE = 32
_COEFF_TILE = 64


@functools.cache
def _kernel():
    lib = _build.library("mdct")
    fn = lib.mdct_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mdct_cuda(x: torch.Tensor, config: MDCTConfig) -> torch.Tensor:
    """Forward MDCT, ``(..., T) -> (..., n_frames, W)``, float32."""
    global launches
    if x.device.type == "cpu":
        return mdct(x, config)
    if x.device.type != "cuda":
        raise ValueError(f"mdct_cuda takes CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"mdct_cuda takes float32, got {x.dtype}")
    if x.ndim == 0:
        raise ValueError("Input must have at least 1 dimension")
    w, hop = config.window_size, config.hop_size
    if hop > w:
        raise ValueError(f"mdct_cuda needs hop <= W, got hop {hop} > W {w}")
    x2d = x.reshape(-1, x.shape[-1])
    if not x2d.is_contiguous():
        raise ValueError("mdct_cuda needs a contiguous signal")
    rows, length = x2d.shape
    nf = num_frames_for_length(length, w, hop)
    out = torch.empty((rows, nf, w), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out.reshape(x.shape[:-1] + (nf, w))
    slots = nf + -(-2 * w // hop) - 1  # frame slots per row, nf + kf - 1
    if (rows * slots > 2**31 - 1 - _SLOT_TILE
            or -(-w // _COEFF_TILE) > _MAX_GRID_Y):
        raise ValueError(f"mdct_cuda: {rows} rows x {nf} frames of {w} is "
                         "beyond the launch grid")
    forward = _kernel()
    with torch.cuda.device(x.device):
        basis = windowed_basis(w, x.device)
        err = forward(x2d.data_ptr(), basis.data_ptr(), out.data_ptr(), rows,
                      length, nf, w, hop,
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mdct kernel launch failed with CUDA error {err}")
    launches += 1
    return out.reshape(x.shape[:-1] + (nf, w))
