"""ctypes binding of the native rANS entropy coder ``native/entropy.cpp``.

Counterpart of ``meanflow_audio_codec_tpu/ops/entropy.py``: a static-model
byte rANS fitted to each stream's code histogram, so stored latent codes
take about their empirical entropy instead of their nominal width. The
repository's C++ source is built with g++ at first use into the package's
``build/`` directory (``ops/_build.py``). Unlike the JAX package, which
stores raw codes when no toolchain is present, a failed build raises with
the compiler's output: the stored format never changes silently.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from meanflow_audio_codec_torch.ops import _build

_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.cache
def _coder() -> ctypes.CDLL:
    lib = _build.library("entropy")
    lib.mac_entropy_encode.restype = ctypes.c_longlong
    lib.mac_entropy_encode.argtypes = [_I8P, ctypes.c_longlong,
                                       _U8P, ctypes.c_longlong]
    lib.mac_entropy_decode.restype = ctypes.c_longlong
    lib.mac_entropy_decode.argtypes = [_U8P, ctypes.c_longlong,
                                       _I8P, ctypes.c_longlong]
    lib.mac_entropy_bound.restype = ctypes.c_longlong
    lib.mac_entropy_bound.argtypes = [ctypes.c_longlong]
    return lib


def entropy_encode(codes: np.ndarray) -> bytes:
    """int8 array (any shape) -> compressed bytes (table + rANS payload)."""
    lib = _coder()
    flat = np.ascontiguousarray(codes, dtype=np.int8).reshape(-1)
    out = np.empty(int(lib.mac_entropy_bound(flat.size)), dtype=np.uint8)
    written = lib.mac_entropy_encode(flat.ctypes.data_as(_I8P), flat.size,
                                     out.ctypes.data_as(_U8P), out.size)
    if written < 0:
        raise RuntimeError("entropy encode failed (buffer bound violated)")
    return out[:written].tobytes()


def entropy_decode(data: bytes, n: int) -> np.ndarray:
    """Compressed bytes -> flat int8 array of exactly ``n`` codes."""
    lib = _coder()
    buf = np.frombuffer(data, dtype=np.uint8)
    codes = np.empty(int(n), dtype=np.int8)
    consumed = lib.mac_entropy_decode(buf.ctypes.data_as(_U8P), buf.size,
                                      codes.ctypes.data_as(_I8P), codes.size)
    if consumed < 0:
        raise ValueError("malformed entropy stream")
    return codes
