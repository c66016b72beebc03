"""OCDBT, the B-tree key-value store inside an orbax checkpoint: a reader
of the newest version and a writer of one version.

Byte layout, as tensorstore 0.1.80 writes it under orbax 0.11 (read off
JAX-written checkpoints; tensorstore lists and reads every key of what this
module writes). Integers are LEB128 varints unless stated.

Every node file (``manifest.ocdbt``, and each B-tree node inside a data
file) is framed the same way::

    magic        u32 big-endian   0x0cdb3a2a manifest, 0x0cdb20de B-tree node
    length       u64 LE           bytes of the whole node, framing included
    version      varint           0
    compression  varint           0 none, 1 zstd (one frame)
    body         the rest, compressed as stated
    crc32c       u32 LE           CRC32C of every byte before it

The manifest's body::

    config: uuid byte[16], manifest_kind (0: the versions are inline),
            max_inline_value_bytes, max_decoded_node_bytes,
            version_tree_arity_log2 u8, compression (1: zstd, then the level
            as int32 LE)
    data file table
    versions: n, then n of each: generation, root height u8, root data
              file id, root offset, root length, num_keys, num_tree_bytes,
              num_indirect_value_bytes, then n commit times (u64 LE, ns)
    version tree nodes: n, then references to older versions (skipped:
              only the newest version is read)

An empty tree's root has offset and length 2**64 - 1.

A data file table names the files a node refers to, each by a base path and
a path relative to it (``ocdbt.process_0/`` and ``d/<32 hex>``), joined
to a path relative to the database's root::

    n, prefix_length[n - 1] (bytes shared with the previous path),
    suffix_length[n], base_path_length[n], the suffixes' bytes

A B-tree node's body::

    height u8 (0: leaf), data file table, n entries, then
    key_prefix_length[n - 1] (bytes shared with the previous key),
    key_suffix_length[n],
    interior only: subtree_common_prefix_length[n],
    the key suffixes' bytes, then
    leaf:     value_length[n], value_kind[n] (0 inline, 1 in a data file),
              for the m indirect values data_file_id[m] and offset[m],
              then the inline values' bytes, concatenated
    interior: child data_file_id[n], offset[n], length[n], and the
              child's num_keys[n], num_tree_bytes[n],
              num_indirect_value_bytes[n]

A node's keys extend the prefix its parent gave it; an interior entry's
key is its child's smallest key, and the child's prefix is the node's
prefix plus the first ``subtree_common_prefix_length`` bytes of it. An
indirect value is the raw bytes at (file, offset, length), with no framing.

The writer puts one version (generation 1, a fresh random uuid) at the
root of the database: every value above ``max_inline_value_bytes`` and
then every node in one data file ``d/<32 hex>``, leaves split where a node's
body would pass ``max_decoded_node_bytes``, interior nodes above them, and
all nodes in raw-block zstd frames with their CRC32C. The configuration
(1024, 100,000,000, arity 2**4, zstd level 0) is the one orbax asks for.
"""

from __future__ import annotations

import io
import os
import struct
import time
import uuid
from dataclasses import dataclass
from pathlib import Path, PurePosixPath
from typing import BinaryIO, Callable

from meanflow_audio_codec_torch.training.orbax import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
NO_COMPRESSION, ZSTD = 0, 1
INLINE, INDIRECT = 0, 1
EMPTY = 2**64 - 1
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
MANIFEST_NAME = "manifest.ocdbt"
#: the largest body a manifest may decode to
_MANIFEST_LIMIT = 1 << 26


# ---------------------------------------------------------------------------
# encoding primitives
# ---------------------------------------------------------------------------


class _Reader:
    """Bounds-checked reads from a node's body; every fault is a
    ``ValueError``."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                if value >= 2**64:
                    raise ValueError(f"{self.what}: varint out of range")
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.raw(struct.calcsize(fmt)))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes left over")


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _prefixed(read: _Reader, n: int, extra: Callable[[], list[int]] | None
              = None) -> tuple[list[bytes], list[int] | None]:
    """``n`` strings stored as prefix lengths, suffix lengths (and an extra
    column read between them and the bytes) then the suffixes."""
    prefix = [0] + read.varints(n - 1) if n else []
    suffix = read.varints(n)
    column = extra() if extra else None
    out, previous = [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            raise ValueError(f"{read.what}: prefix longer than the previous "
                             "string")
        previous = previous[:prefix[i]] + read.raw(suffix[i])
        out.append(previous)
    return out, column


def _encode_prefixed(strings: list[bytes], column: list[int] | None = None
                     ) -> bytes:
    prefix = [_shared(a, b) for a, b in zip(strings, strings[1:])]
    suffix = [len(s) - p for s, p in zip(strings, [0] + prefix)]
    body = _varints(prefix) + _varints(suffix)
    if column is not None:
        body += _varints(column)
    return body + b"".join(s[p:] for s, p in zip(strings, [0] + prefix))


def _read_files(read: _Reader) -> list[str]:
    n = read.varint()
    paths, bases = _prefixed(read, n, lambda: read.varints(n))
    files = []
    for path, base in zip(paths, bases):
        if base > len(path):
            raise ValueError(f"{read.what}: base path longer than its path")
        files.append(_relative(path.decode()))
    return files


def _encode_files(files: list[str]) -> bytes:
    encoded = [f.encode() for f in files]
    return _varint(len(files)) + _encode_prefixed(encoded,
                                                  [0] * len(files))


def _relative(path: str) -> str:
    """A data file's path, refused where it would leave the database."""
    if path == "":
        return path
    pure = PurePosixPath(path)
    if pure.is_absolute() or ".." in pure.parts:
        raise ValueError(f"data file path {path!r} leaves the database")
    return path


def frame_node(magic: int, body: bytes) -> bytes:
    """A node's bytes: the framing, the body in a raw-block zstd frame and
    the CRC32C."""
    payload = zstd.frame(body)
    length = 4 + 8 + 2 + len(payload) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + bytes(
        [FORMAT_VERSION, ZSTD])
    data = head + payload
    return data + struct.pack("<I", zstd.crc32c(data))


def unframe_node(data: bytes, magic: int, what: str,
                 limit: int = MAX_DECODED_NODE_BYTES) -> bytes:
    """A node's body, after checking its magic, length, version,
    compression and CRC32C."""
    if len(data) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: {len(data)} bytes is too short")
    got_magic, = struct.unpack(">I", data[:4])
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x} where "
                         f"{magic:#010x} was expected")
    length, = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise ValueError(f"{what}: length field {length} but {len(data)} "
                         "bytes")
    crc, = struct.unpack("<I", data[-4:])
    if zstd.crc32c(memoryview(data)[:-4]) != crc:
        raise ValueError(f"{what}: CRC32C mismatch")
    read = _Reader(data[:-4], what)
    read.pos = 12
    version = read.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"{what}: unknown format version {version}")
    compression = read.varint()
    payload = data[read.pos:-4]
    if compression == NO_COMPRESSION:
        return payload
    if compression == ZSTD:
        return zstd.decompress(payload, limit=limit)
    raise ValueError(f"{what}: unknown compression {compression}")


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    uuid: bytes
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int
    zstd_level: int = 0


@dataclass(frozen=True)
class Location:
    """Bytes at ``offset`` in the data file ``file`` (relative to the
    database's root)."""
    file: str
    offset: int
    length: int


def _read_config(read: _Reader) -> Config:
    ident = read.raw(16)
    kind = read.varint()
    if kind != 0:
        raise ValueError(f"{read.what}: manifest kind {kind} (numbered "
                         "manifests) is not supported")
    inline, decoded = read.varint(), read.varint()
    arity = read.u8()
    compression = read.varint()
    level = 0
    if compression == ZSTD:
        level, = read.unpack("<i")
    elif compression != NO_COMPRESSION:
        raise ValueError(f"{read.what}: unknown compression {compression}")
    return Config(ident, inline, decoded, arity, compression, level)


class Database:
    """The newest version of an OCDBT database: its keys, each with its
    inline value or the location of its value."""

    def __init__(self, root: Path | str):
        self.root = Path(root)
        manifest = self.root / MANIFEST_NAME
        what = str(manifest)
        body = unframe_node(_read(manifest), MANIFEST_MAGIC, what,
                            _MANIFEST_LIMIT)
        read = _Reader(body, what)
        self.config = _read_config(read)
        files = _read_files(read)
        n = read.varint()
        if n == 0:
            raise ValueError(f"{what}: no version")
        generation = read.varints(n)
        height = [read.u8() for _ in range(n)]
        file_id, offset, length = (read.varints(n), read.varints(n),
                                   read.varints(n))
        stats = [read.varints(n) for _ in range(3)]
        read.raw(8 * n)  # commit times
        read.varint()  # references to older versions, not read
        newest = max(range(n), key=generation.__getitem__)
        self.generation = generation[newest]
        self.num_keys = stats[0][newest]
        self.entries: dict[bytes, bytes | Location] = {}
        if offset[newest] != EMPTY:
            if file_id[newest] >= len(files):
                raise ValueError(f"{what}: data file id out of range")
            self._walk(Location(files[file_id[newest]], offset[newest],
                                length[newest]), height[newest], b"")
        if len(self.entries) != self.num_keys:
            raise ValueError(f"{what}: {len(self.entries)} keys where the "
                             f"manifest counts {self.num_keys}")

    def _node(self, at: Location) -> bytes:
        what = f"{self.root / at.file}@{at.offset}"
        return unframe_node(self._bytes(at), NODE_MAGIC, what,
                            self.config.max_decoded_node_bytes)

    def _walk(self, at: Location, height: int, prefix: bytes) -> None:
        read = _Reader(self._node(at), f"{self.root / at.file}@{at.offset}")
        got = read.u8()
        if got != height:
            raise ValueError(f"{read.what}: height {got} where {height} was "
                             "expected")
        files = _read_files(read)
        n = read.varint()
        if n == 0:
            raise ValueError(f"{read.what}: a node without entries")
        if height == 0:
            keys, _ = _prefixed(read, n)
            lengths = read.varints(n)
            kinds = read.varints(n)
            if any(k not in (INLINE, INDIRECT) for k in kinds):
                raise ValueError(f"{read.what}: unknown value kind")
            m = kinds.count(INDIRECT)
            ids, offsets = read.varints(m), read.varints(m)
            indirect = iter(zip(ids, offsets))
            for key, size, kind in zip(keys, lengths, kinds):
                if kind == INLINE:
                    value = read.raw(size)
                else:
                    fid, offset = next(indirect)
                    if fid >= len(files):
                        raise ValueError(f"{read.what}: data file id out "
                                         "of range")
                    value = Location(files[fid], offset, size)
                self._add(prefix + key, value, read.what)
            read.done()
            return
        keys, common = _prefixed(read, n, lambda: read.varints(n))
        ids, offsets, lengths = (read.varints(n), read.varints(n),
                                 read.varints(n))
        for _ in range(3):  # the children's statistics
            read.varints(n)
        read.done()
        for key, shared, fid, offset, length in zip(keys, common, ids,
                                                    offsets, lengths):
            if shared > len(key) or fid >= len(files):
                raise ValueError(f"{read.what}: malformed interior entry")
            self._walk(Location(files[fid], offset, length), height - 1,
                       prefix + key[:shared])

    def _add(self, key: bytes, value, what: str) -> None:
        if key in self.entries:
            raise ValueError(f"{what}: key {key!r} twice")
        self.entries[key] = value

    def _bytes(self, at: Location) -> bytes:
        return _read(self.root / at.file, at.offset, at.length)

    def keys(self) -> list[bytes]:
        return sorted(self.entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self.entries

    def read(self, key: bytes) -> bytes:
        """A key's value; raises ``KeyError`` for a missing key and
        ``ValueError`` when its data file is short."""
        value = self.entries[key]
        if isinstance(value, Location):
            return self._bytes(value)
        return value


def _read(path: Path, offset: int = 0, length: int | None = None) -> bytes:
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
    except OSError as exc:
        raise ValueError(f"{path}: {exc}") from None
    if length is not None and len(data) != length:
        raise ValueError(f"{path}: {len(data)} bytes at offset {offset} "
                         f"where {length} were expected (truncated file)")
    return data


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


@dataclass
class _Child:
    key: bytes  # the subtree's smallest key
    at: Location
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


class Writer:
    """Write one version of a database at ``root``: ``put`` each key, then
    ``commit``. Values above ``max_inline_value_bytes`` go to the data file
    as they are put; the nodes and the manifest at ``commit``."""

    def __init__(self, root: Path | str,
                 max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
                 max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES):
        self.root = Path(root)
        self.max_inline = max_inline_value_bytes
        self.max_node = max_decoded_node_bytes
        self.data_name = f"d/{uuid.uuid4().hex}"
        (self.root / "d").mkdir(parents=True, exist_ok=True)
        self._file: BinaryIO = open(self.root / self.data_name, "wb")
        self._offset = 0
        self._values: dict[bytes, bytes | Location] = {}

    def put(self, key: bytes, value) -> None:
        """Store ``value`` (bytes-like) under ``key``."""
        size = memoryview(value).nbytes
        self.put_stream(key, size, lambda f: f.write(value))

    def put_stream(self, key: bytes, size: int,
                   write: Callable[[BinaryIO], object]) -> None:
        """Store ``size`` bytes that ``write(file)`` writes, without
        holding them when they go to the data file."""
        if key in self._values:
            raise ValueError(f"key {key!r} put twice")
        if size <= self.max_inline:
            buffer = io.BytesIO()
            write(buffer)
            value = buffer.getvalue()
            if len(value) != size:
                raise ValueError(f"{key!r}: wrote {len(value)} of {size} "
                                 "bytes")
            self._values[key] = value
            return
        start = self._file.tell()
        write(self._file)
        if self._file.tell() - start != size:
            raise ValueError(f"{key!r}: wrote {self._file.tell() - start} "
                             f"of {size} bytes")
        self._values[key] = Location(self.data_name, start, size)

    def _write_node(self, body: bytes) -> Location:
        data = frame_node(NODE_MAGIC, body)
        start = self._file.tell()
        self._file.write(data)
        return Location(self.data_name, start, len(data))

    def _leaf_body(self, keys: list[bytes]) -> bytes:
        values = [self._values[k] for k in keys]
        indirect = [v for v in values if isinstance(v, Location)]
        files = [self.data_name] if indirect else []
        return (bytes([0]) + _encode_files(files) + _varint(len(keys))
                + _encode_prefixed(keys)
                + _varints(len(v) if isinstance(v, bytes) else v.length
                           for v in values)
                + bytes(INDIRECT if isinstance(v, Location) else INLINE
                        for v in values)
                + _varints(0 for _ in indirect)
                + _varints(v.offset for v in indirect)
                + b"".join(v for v in values if isinstance(v, bytes)))

    def _interior_body(self, height: int, children: list[_Child]) -> bytes:
        n = len(children)
        return (bytes([height]) + _encode_files([self.data_name])
                + _varint(n)
                + _encode_prefixed([c.key for c in children], [0] * n)
                + _varints(0 for _ in children)
                + _varints(c.at.offset for c in children)
                + _varints(c.at.length for c in children)
                + _varints(c.num_keys for c in children)
                + _varints(c.tree_bytes for c in children)
                + _varints(c.indirect_bytes for c in children))

    def _entry_bytes(self, key: bytes) -> int:
        """An upper bound of what one more leaf entry adds to a body."""
        value = self._values[key]
        size = len(key) + 2 * 10 + 1
        if isinstance(value, bytes):
            return size + 10 + len(value)
        return size + 3 * 10

    def _leaves(self, keys: list[bytes]) -> list[_Child]:
        groups: list[list[bytes]] = []
        current: list[bytes] = []
        size = 64 + len(self.data_name)  # height, file table, count
        for key in keys:
            add = self._entry_bytes(key)
            if current and size + add > self.max_node:
                groups.append(current)
                current, size = [], 64 + len(self.data_name)
            current.append(key)
            size += add
        if current:
            groups.append(current)
        children = []
        for group in groups:
            at = self._write_node(self._leaf_body(group))
            indirect = sum(v.length for v in map(self._values.get, group)
                           if isinstance(v, Location))
            children.append(_Child(group[0], at, len(group), at.length,
                                   indirect))
        return children

    def _level(self, height: int, children: list[_Child]) -> list[_Child]:
        groups: list[list[_Child]] = []
        current: list[_Child] = []
        size = 64 + len(self.data_name)
        for child in children:
            add = len(child.key) + 9 * 10
            if current and size + add > self.max_node:
                groups.append(current)
                current, size = [], 64 + len(self.data_name)
            current.append(child)
            size += add
        groups.append(current)
        parents = []
        for group in groups:
            at = self._write_node(self._interior_body(height, group))
            parents.append(_Child(
                group[0].key, at, sum(c.num_keys for c in group),
                at.length + sum(c.tree_bytes for c in group),
                sum(c.indirect_bytes for c in group)))
        return parents

    def close(self) -> None:
        """Close the data file without committing (after a failed put)."""
        self._file.close()

    def commit(self) -> None:
        """Write the nodes and then the manifest; the database is complete
        once this returns."""
        keys = sorted(self._values)
        height = 0
        level = self._leaves(keys) if keys else []
        while len(level) > 1:
            height += 1
            level = self._level(height, level)
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        if level:
            root = level[0]
            files = [self.data_name]
            version = (0, root.at.offset, root.at.length, root.num_keys,
                       root.tree_bytes, root.indirect_bytes)
        else:
            (self.root / self.data_name).unlink()
            files = [""]
            version = (0, EMPTY, EMPTY, 0, 0, 0)
        config = (uuid.uuid4().bytes + _varint(0)
                  + _varint(self.max_inline) + _varint(self.max_node)
                  + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(ZSTD)
                  + struct.pack("<i", 0))
        body = (config + _encode_files(files) + _varint(1) + _varint(1)
                + bytes([height]) + _varints(version)
                + struct.pack("<Q", time.time_ns()) + _varint(0))
        manifest = self.root / MANIFEST_NAME
        manifest.write_bytes(frame_node(MANIFEST_MAGIC, body))
