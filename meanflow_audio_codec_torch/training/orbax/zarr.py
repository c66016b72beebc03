"""zarr v2 arrays in a key-value store, as orbax 0.11 lays them out: an
array ``name`` is the key ``name/.zarray`` (its JSON description) and one
key per chunk, ``name/i.j...`` (``name/0`` for a 0-d array), each chunk a
zstd frame of the chunk's bytes in C order.

Written arrays are one chunk (orbax's default) with orbax's description:
``{"chunks": shape, "compressor": {"id": "zstd", "level": 1},
"dimension_separator": ".", "dtype": ..., "fill_value": null, "filters":
null, "order": "C", "shape": shape, "zarr_format": 2}``; the chunk is a
raw-block frame (``zstd.write_frame``). Reading takes any chunk grid; a
missing chunk reads as the fill value, and an unknown compressor, filter,
dtype or order raises ``ValueError``.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import torch

from meanflow_audio_codec_torch.training.orbax import ocdbt, zstd

COMPRESSOR = {"id": "zstd", "level": 1}
#: zarr dtype -> (numpy dtype of the stored bytes, torch dtype)
DTYPES = {
    "<f4": (np.float32, torch.float32),
    "<f8": (np.float64, torch.float64),
    "<i4": (np.int32, torch.int32),
    "<i8": (np.int64, torch.int64),
    "<u4": (np.uint32, None),
    "|b1": (np.bool_, torch.bool),
    "bfloat16": (np.uint16, torch.bfloat16),
}
_TORCH_NAMES = {torch.float32: "<f4", torch.float64: "<f8",
                torch.int32: "<i4", torch.int64: "<i8", torch.bool: "|b1",
                torch.bfloat16: "bfloat16"}


def dtype_name(value) -> str:
    """The zarr dtype of a tensor or numpy array."""
    if isinstance(value, torch.Tensor):
        name = _TORCH_NAMES.get(value.dtype)
    else:
        name = np.dtype(value.dtype).newbyteorder("<").str
        name = name if name in DTYPES else None
    if name is None:
        raise TypeError(f"no zarr dtype for {value.dtype}")
    return name


def _host_bytes(value) -> np.ndarray:
    """The array's bytes in C order as a flat uint8 array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu").contiguous()
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        value = value.numpy()
    return np.ascontiguousarray(value).reshape(-1).view(np.uint8)


def description(shape: tuple[int, ...], dtype: str) -> bytes:
    return json.dumps({"chunks": list(shape), "compressor": COMPRESSOR,
                       "dimension_separator": ".", "dtype": dtype,
                       "fill_value": None, "filters": None, "order": "C",
                       "shape": list(shape), "zarr_format": 2},
                      separators=(",", ":")).encode()


def write_array(writer: ocdbt.Writer, name: str, value) -> None:
    """Put ``value`` (a tensor or numpy array) as the one-chunk array
    ``name``."""
    shape = tuple(int(d) for d in value.shape)
    dtype = dtype_name(value)
    writer.put(f"{name}/.zarray".encode(), description(shape, dtype))
    data = _host_bytes(value)
    chunk = ".".join("0" for _ in shape) or "0"
    writer.put_stream(f"{name}/{chunk}".encode(),
                      zstd.frame_size(data.nbytes),
                      lambda f: zstd.write_frame(f, data))


def _fill(meta: dict, dtype) -> np.ndarray:
    fill = meta.get("fill_value")
    if fill is None:
        fill = 0
    elif isinstance(fill, str):  # "NaN", "Infinity", "-Infinity"
        fill = float(fill)
    return np.asarray(fill).astype(dtype)


def read_array(db: ocdbt.Database, name: str) -> torch.Tensor:
    """The array ``name`` as a CPU tensor (``bfloat16`` as
    ``torch.bfloat16``, ``<u4`` as int64: torch has no uint32)."""
    try:
        meta = json.loads(db.read(f"{name}/.zarray".encode()))
    except KeyError:
        raise ValueError(f"no zarr array {name!r}") from None
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta.get('order')!r}")
    if meta.get("filters") not in (None, []):
        raise ValueError(f"{name}: unknown filters {meta['filters']!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: unknown compressor {compressor!r}")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{name}: unknown dtype {meta.get('dtype')!r}")
    np_dtype, torch_dtype = DTYPES[meta["dtype"]]
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{name}: dimension separator "
                         f"{meta['dimension_separator']!r}")
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    out = np.empty(shape, dtype=np_dtype)
    itemsize = np.dtype(np_dtype).itemsize
    chunk_bytes = math.prod(chunks) * itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{name}/{'.'.join(map(str, index)) or '0'}".encode()
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        if key not in db:
            out[region] = _fill(meta, np_dtype)
            continue
        stored = db.read(key)
        if compressor and chunks == shape:  # one chunk: decode in place
            flat = out.reshape(-1).view(np.uint8)
            if zstd.decompress_into(stored, flat) != chunk_bytes:
                raise ValueError(f"{key!r}: decoded size differs from "
                                 f"{chunk_bytes} bytes")
            continue
        data = (zstd.decompress(stored, chunk_bytes) if compressor
                else stored)
        if len(data) != chunk_bytes:
            raise ValueError(f"{key!r}: {len(data)} bytes where "
                             f"{chunk_bytes} were expected")
        block = np.frombuffer(data, dtype=np_dtype).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if torch_dtype is None:  # uint32: widened, torch has no uint32 tensor
        return torch.from_numpy(out.astype(np.int64))
    tensor = torch.from_numpy(out)
    return tensor.view(torch.bfloat16) if torch_dtype == torch.bfloat16 \
        else tensor
