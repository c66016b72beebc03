"""zstd frames: the hand-written decoder of ``csrc/zstd.cpp`` through
ctypes, CRC32C, and a writer of frames made of raw blocks.

The decoder (RFC 8878, every block and literal kind, FSE and Huffman)
builds with g++ at first use into the package's ``build/`` directory
(``ops/_build.py``); a failed build raises with g++'s output. Its error
codes become ``ValueError`` with their meaning.

The writer emits valid zstd that compresses nothing: a frame header with
the content size, then the data in raw blocks (``Block_Type`` 0) of at most
128 KiB. Any zstd reader (tensorstore's among them) reads it; on random
float32 weights it is about 3% larger than zstd level 1.
"""

from __future__ import annotations

import ctypes
import functools
import io
import struct
from typing import BinaryIO

import numpy as np

from meanflow_audio_codec_torch.ops import _build

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
#: the window descriptor of frames of 256 bytes or more: 128 KiB, the
#: largest block, since raw blocks refer to nothing before them
_WINDOW_128K = (17 - 10) << 3
ERR_DST_TOO_SMALL = -5


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("zstd")
    lib.zstd_decompress.restype = ctypes.c_longlong
    lib.zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_longlong]
    lib.zstd_content_size.restype = ctypes.c_longlong
    lib.zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.zstd_error_name.restype = ctypes.c_char_p
    lib.zstd_error_name.argtypes = [ctypes.c_int]
    lib.zstd_crc32c.restype = ctypes.c_uint
    lib.zstd_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_uint]
    return lib


def _buffer(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


def _error(code: int) -> ValueError:
    name = _lib().zstd_error_name(int(code)).decode()
    return ValueError(f"zstd: {name} (code {code})")


def content_size(data) -> int | None:
    """The decoded size the frames in ``data`` declare, or None when a
    frame declares none; raises ``ValueError`` on a malformed header."""
    src = _buffer(data)
    size = _lib().zstd_content_size(src.ctypes.data, src.size)
    if size == -1:
        return None
    if size < 0:
        raise _error(size)
    return int(size)


def decompress_into(data, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into the uint8 array ``out``; returns
    the bytes written; raises ``ValueError`` on malformed input or when
    the frames decode to more than ``out`` holds."""
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("zstd: the output must be a contiguous uint8 array")
    src = _buffer(data)
    got = _lib().zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                                 out.size)
    if got < 0:
        raise _error(got)
    return int(got)


def decompress(data, size: int | None = None, limit: int = 1 << 31
               ) -> bytes:
    """The decoded bytes of ``data`` (one or more frames).

    ``size`` is the size the caller expects (a zarr chunk's shape times its
    item size): a frame that decodes to another raises ``ValueError``.
    Without it the frames' declared content size is used, and where they
    declare none the buffer grows up to ``limit`` bytes.
    """
    if size is not None:
        out = np.empty(size, dtype=np.uint8)
        got = decompress_into(data, out)
        if got != size:
            raise ValueError(f"zstd: decoded {got} bytes where {size} were "
                             "expected")
        return out.tobytes()
    declared = content_size(data)
    if declared is not None:
        return decompress(data, declared)
    cap = min(limit, 4 * len(data) + 65536)
    src = _buffer(data)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        got = _lib().zstd_decompress(src.ctypes.data, src.size,
                                     out.ctypes.data, out.size)
        if got >= 0:
            return out[:got].tobytes()
        if got != ERR_DST_TOO_SMALL or cap >= limit:
            raise _error(got)
        cap = min(limit, 4 * cap)


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continued from ``crc``."""
    src = _buffer(data)
    return int(_lib().zstd_crc32c(src.ctypes.data, src.size, crc))


# ---------------------------------------------------------------------------
# raw-block frames
# ---------------------------------------------------------------------------


def _frame_header(size: int) -> bytes:
    if size < 256:  # single segment, a 1-byte content size
        return struct.pack("<IBB", MAGIC, 0x20, size)
    if size < 65536 + 256:
        return struct.pack("<IBBH", MAGIC, 1 << 6, _WINDOW_128K, size - 256)
    if size < 1 << 32:
        return struct.pack("<IBBI", MAGIC, 2 << 6, _WINDOW_128K, size)
    return struct.pack("<IBBQ", MAGIC, 3 << 6, _WINDOW_128K, size)


def _block_header(size: int, last: bool) -> bytes:
    return (int(last) | (size << 3)).to_bytes(3, "little")


def frame_size(size: int) -> int:
    """Bytes of the raw-block frame of ``size`` bytes of content."""
    blocks = max(1, -(-size // BLOCK_MAX))
    return len(_frame_header(size)) + 3 * blocks + size


def write_frame(file: BinaryIO, data) -> int:
    """Write ``data`` (bytes-like) to ``file`` as one raw-block frame;
    returns the bytes written."""
    view = memoryview(data).cast("B")
    size = view.nbytes
    file.write(_frame_header(size))
    if size == 0:
        file.write(_block_header(0, True))
    for start in range(0, size, BLOCK_MAX):
        end = min(start + BLOCK_MAX, size)
        file.write(_block_header(end - start, end == size))
        file.write(view[start:end])
    return frame_size(size)


def frame(data) -> bytes:
    """``data`` as one raw-block frame."""
    buffer = io.BytesIO()
    write_frame(buffer, data)
    return buffer.getvalue()
