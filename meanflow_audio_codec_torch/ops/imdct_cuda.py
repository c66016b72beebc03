"""Inverse MDCT through the hand-written CUDA kernel ``csrc/imdct.cu``.

Counterpart of ``meanflow_audio_codec_tpu/ops/imdct_pallas.py``. A CPU
tensor goes to the plain version (``ops/mdct.py``); a CUDA tensor goes to the
kernel, or the wrapper raises. ``launches`` counts kernel launches. The kernel
tiles all rows' hop-sized output chunks as one GEMM (``csrc/imdct.cu``), so
its shared memory does not depend on W, hop or the frame count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from meanflow_audio_codec_torch.ops import _build
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    imdct,
    imdct_scale,
    output_length,
    windowed_basis,
)

#: kernel launches since the count was last set to 0
launches = 0

_MAX_GRID_Y = 65535
# a block's output tile: hop-sized chunks x samples (kBM, kBN in tile_core.cuh)
_CHUNK_TILE = 32
_SAMPLE_TILE = 64


@functools.cache
def _kernel():
    lib = _build.library("imdct")
    fn = lib.imdct_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def imdct_cuda(X: torch.Tensor, config: MDCTConfig) -> torch.Tensor:
    """Inverse MDCT, ``(..., n_frames, W) -> (..., (nf-1)*hop + 2W)``, float32."""
    global launches
    if X.device.type == "cpu":
        return imdct(X, config)
    if X.device.type != "cuda":
        raise ValueError(f"imdct_cuda takes CPU or CUDA tensors, got {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"imdct_cuda takes float32, got {X.dtype}")
    w, hop = config.window_size, config.hop_size
    if X.ndim < 2 or X.shape[-1] != w:
        raise ValueError(f"imdct_cuda needs (..., n_frames, {w}), got "
                         f"{tuple(X.shape)}")
    if hop > w:
        raise ValueError(f"imdct_cuda needs hop <= W, got hop {hop} > W {w}")
    x3d = X.reshape(-1, X.shape[-2], w)
    if not x3d.is_contiguous():
        raise ValueError("imdct_cuda needs contiguous coefficients")
    rows, nf, _ = x3d.shape
    out_len = output_length(nf, w, hop)
    out = torch.empty((rows, out_len), dtype=torch.float32, device=X.device)
    if rows == 0 or nf == 0:
        return out.reshape(X.shape[:-2] + (out_len,))
    chunks = nf + -(-2 * w // hop) - 1  # hop-sized output chunks per row
    if (rows * chunks > 2**31 - 1 - _CHUNK_TILE
            or -(-hop // _SAMPLE_TILE) > _MAX_GRID_Y):
        raise ValueError(f"imdct_cuda: {rows} rows x {out_len} samples is "
                         "beyond the launch grid")
    forward = _kernel()
    with torch.cuda.device(X.device):
        basis_t = windowed_basis(w, X.device, transposed=True)
        err = forward(x3d.data_ptr(), basis_t.data_ptr(), out.data_ptr(), rows,
                      nf, w, hop, imdct_scale(config),
                      torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"imdct kernel launch failed with CUDA error {err}")
    launches += 1
    return out.reshape(X.shape[:-2] + (out_len,))
