"""Flax's msgpack checkpoint format, read and written in pure Python.

Counterpart of ``msgpack_serialize`` / ``msgpack_restore`` in
``flax/serialization.py``, for the trees a checkpoint holds: maps with str
keys, arrays (lists and tuples), str, int, float, bool, nil, bin, and two
msgpack extension types:

  * ext 1, an array: the msgpack array ``(shape, dtype name, C-order bytes)``;
  * ext 3, a numpy scalar: the same encoding with shape ``()``.

Arrays above 2**30 bytes are split as flax splits them, into a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": flat chunk, ...}}``. The writer packs as msgpack-python packs with
flax's settings (smallest int and length headers, float64 floats, str as
str and bytes as bin), so it gives flax's bytes for the same tree.

Arrays are read as CPU ``torch.Tensor``s (bfloat16 included, which numpy
lacks); the writer takes tensors, numpy arrays and numpy scalars. No
``flax`` and no ``msgpack`` is needed.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ============================================================================
# Writer
# ============================================================================


def _header(out: list, n: int, fix: int | None, fix_max: int,
            codes: tuple[int, int, int]) -> None:
    """Length header: a fix form below ``fix_max``, else 8/16/32-bit."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] and n <= 0xFF:
        out.append(bytes([codes[0], n]))
    elif n <= 0xFFFF:
        out.append(bytes([codes[1]]) + struct.pack(">H", n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes([codes[2]]) + struct.pack(">I", n))
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: list, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(bytes([x]))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if x >= low:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n <= 0xFF:
        out.append(bytes([0xC7, n, code]))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n) + bytes([code]))
    else:
        out.append(b"\xc9" + struct.pack(">I", n) + bytes([code]))
    out.append(data)


def _array_parts(value) -> tuple[tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a tensor or numpy array."""
    if isinstance(value, torch.Tensor):
        tensor = value.detach().cpu().contiguous()
        name = _DTYPE_NAMES.get(tensor.dtype)
        if name is None:
            raise TypeError(f"cannot write a {tensor.dtype} tensor")
        if tensor.dtype == torch.bfloat16:  # numpy has no bfloat16
            tensor = tensor.view(torch.int16)
        return tuple(value.shape), name, tensor.numpy().tobytes()
    array = np.asarray(value)
    if array.dtype.hasobject or array.dtype.fields:
        raise TypeError("object and structured dtypes are not supported")
    return array.shape, array.dtype.name, array.tobytes("C")


def _array_bytes(value) -> bytes:
    shape, name, data = _array_parts(value)
    out: list = []
    _header(out, 3, 0x90, 16, (0, 0xDC, 0xDD))
    _header(out, len(shape), 0x90, 16, (0, 0xDC, 0xDD))
    for dim in shape:
        _pack_int(out, int(dim))
    _pack_str(out, name)
    _header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(data)
    return b"".join(out)


def _pack_str(out: list, s: str) -> None:
    data = s.encode("utf-8")
    _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out.append(data)


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return value.nbytes


def _chunked(value) -> dict:
    """flax's chunked form of an array above ``MAX_CHUNK_SIZE`` bytes."""
    flat = value.reshape(-1)
    itemsize = (value.element_size() if isinstance(value, torch.Tensor)
                else value.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(value.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: list, x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        _pack_str(out, x)
    elif isinstance(x, (bytes, bytearray)):
        _header(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(x))
    elif isinstance(x, Mapping):
        _header(out, len(x), 0x80, 16, (0, 0xDE, 0xDF))
        for key, value in x.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {key!r}")
            _pack_str(out, key)
            _pack(out, value)
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 16, (0, 0xDC, 0xDD))
        for value in x:
            _pack(out, value)
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(out, _chunked(x))
        else:
            _pack_ext(out, _EXT_NDARRAY, _array_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    else:
        raise TypeError(f"cannot write {type(x).__name__} to msgpack")


def msgpack_serialize(tree: Any) -> bytes:
    """Bytes of ``tree`` in flax's msgpack format."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


# ============================================================================
# Reader
# ============================================================================


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in simple:
            return simple[code]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
                 0xDC: ">H", 0xDD: ">I",  # array
                 0xDE: ">H", 0xDF: ">I",  # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        if code in sized:
            n = self.unpack(sized[code])
            if code <= 0xC6:
                return bytes(self.take(n))
            if code <= 0xC9:
                return self.ext(self.unpack(">b"), n)
            if code <= 0xDB:
                return str(self.take(n), "utf-8")
            return self.array(n) if code <= 0xDD else self.map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if code in numbers:
            return self.unpack(numbers[code])
        if 0xD4 <= code <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack(">b"), 1 << (code - 0xD4))
        raise ValueError(f"unknown msgpack type byte 0x{code:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        inner = _Reader(data)
        shape, name, buffer = inner.read()
        if isinstance(name, bytes):
            name = name.decode()
        tensor = _tensor_from_buffer(buffer, name, tuple(shape))
        if code == _EXT_NPSCALAR and name != "bfloat16":
            return tensor.numpy()[()]
        return tensor


def _tensor_from_buffer(buffer: bytes, name: str,
                        shape: tuple[int, ...]) -> torch.Tensor:
    dtype = _TORCH_DTYPES.get(name)
    if dtype is None:
        raise ValueError(f"unsupported array dtype {name!r}")
    if dtype == torch.bfloat16:
        array = np.frombuffer(buffer, dtype=np.int16).copy()
        return torch.from_numpy(array).view(torch.bfloat16).reshape(shape)
    array = np.frombuffer(buffer, dtype=np.dtype(name)).copy()
    return torch.from_numpy(array).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return {key: _unchunk(value) for key, value in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree in ``data`` (flax's msgpack format), arrays as CPU tensors."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return _unchunk(tree)
