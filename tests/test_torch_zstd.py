"""PyTorch port: the hand-written zstd decoder (``csrc/zstd.cpp``) against
the ``zstandard`` package, the raw-block frame writer and CRC32C.

Tolerance: none. Every frame must decode to exactly the bytes
``zstandard`` compressed, and every malformed frame must raise
``ValueError`` without taking the process down (the fuzz case runs in a
subprocess, so a crash fails the test and not the worker).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from meanflow_audio_codec_torch.ops import _build
from meanflow_audio_codec_torch.training.orbax import zstd

REPO = Path(__file__).resolve().parents[1]
LEVELS = [-5, 1, 3, 9, 19]


def _data(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size)
    if kind == "random":
        return rng.bytes(size)
    if kind == "f32":
        return rng.standard_normal(size // 4).astype(np.float32).tobytes()
    if kind == "zeros":
        return bytes(size)
    if kind == "text":
        text = (REPO / "README.md").read_bytes()
        return (text * (size // len(text) + 1))[:size]
    # repeated patterns of several periods, with a little noise between
    parts, total = [], 0
    while total < size:
        period = int(rng.integers(1, 300))
        unit = rng.bytes(period) * int(rng.integers(2, 40))
        parts += [unit, rng.bytes(int(rng.integers(0, 20)))]
        total += len(parts[-2]) + len(parts[-1])
    return b"".join(parts)[:size]


def _compress(data: bytes, level: int, content_size=True, checksum=False
              ) -> bytes:
    return zstandard.ZstdCompressor(
        level=level, write_content_size=content_size,
        write_checksum=checksum).compress(data)


def _streamed(data: bytes, level: int) -> bytes:
    """A frame without a content size, as a stream writes it."""
    compressor = zstandard.ZstdCompressor(level=level).compressobj()
    return compressor.compress(data) + compressor.flush()


def test_the_decoder_builds_into_the_package_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    """No fallback: a decoder that does not build raises with g++'s
    output, and no orbax checkpoint is read without it."""
    zstd.crc32c(b"")
    assert _build.library_path("zstd").parent == _build.BUILD_DIR
    broken = tmp_path / "zstd.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "zstd", broken)
    monkeypatch.setattr(_build, "_libraries", {})
    zstd._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
            zstd.decompress(zstd.frame(b"abc"), 3)
        assert "zstd.cpp" in str(info.value)
        assert not _build.library_path("zstd").exists()
    finally:
        zstd._lib.cache_clear()


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(b"6789", zstd.crc32c(b"12345")) == 0xE3069283


@pytest.mark.parametrize("kind", ["random", "f32", "zeros", "text",
                                  "patterns"])
@pytest.mark.parametrize("level", LEVELS)
def test_frames_decode_as_zstandard_compressed_them(level, kind):
    for size in (0, 1, 100, 4096, 150_000, 1_000_000):
        if level == 19 and size > 200_000 and kind in ("random", "text"):
            continue  # level 19 on a megabyte takes seconds to compress
        data = _data(kind, size)
        for content_size, checksum in ((True, False), (True, True),
                                       (False, True)):
            frame = _compress(data, level, content_size, checksum)
            assert zstd.decompress(frame, len(data)) == data, (size,
                                                               content_size)
            if content_size:
                assert zstd.content_size(frame) == len(data)
        streamed = _streamed(data, level)
        if data:  # an empty stream's frame states its size, 0
            assert zstd.content_size(streamed) is None
        assert zstd.decompress(streamed) == data


def test_concatenated_and_skippable_frames():
    parts = [_data("text", 5000), _data("f32", 70_000), b"",
             _data("patterns", 300_000)]
    skippable = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(
        4, "little") + b"ignored"
    frames = b"".join(_compress(p, level) + skippable
                      for p, level in zip(parts, (1, 3, 9, -5)))
    whole = b"".join(parts)
    assert zstd.decompress(frames, len(whole)) == whole
    assert zstd.content_size(frames) == len(whole)
    # frames whose matches reach back across blocks inside one frame
    long = _data("patterns", 900_000)
    assert zstd.decompress(_streamed(long, 3)) == long


@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=20_000), st.sampled_from(LEVELS),
       st.booleans())
def test_any_bytes_round_trip(data, level, checksum):
    frame = _compress(data, level, checksum=checksum)
    assert zstd.decompress(frame, len(data)) == data


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, 131072,
                                  131073, 600_000])
def test_raw_block_frames_decode_in_both(size):
    data = _data("f32", size) if size >= 4 else bytes(range(size))
    data = (data + bytes(size))[:size]
    frame = zstd.frame(data)
    assert len(frame) == zstd.frame_size(size)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame, size) == data
    assert zstd.content_size(frame) == size


def test_wrong_sizes_and_checksums_raise():
    data = _data("text", 50_000)
    frame = _compress(data, 3, checksum=True)
    with pytest.raises(ValueError, match="more bytes than expected"):
        zstd.decompress(frame, len(data) - 1)
    with pytest.raises(ValueError, match="decoded 50000 bytes"):
        zstd.decompress(frame, len(data) + 1)
    broken = bytearray(frame)
    broken[-1] ^= 0xFF  # the checksum's last byte
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(broken), len(data))
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(frame[:-100], len(data))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" * 16, 16)
    # the same frame naming a dictionary: a dictionary ID byte after the
    # header descriptor (and the window descriptor where there is one)
    plain = _compress(b"abc" * 100, 1, content_size=False)
    fhd = plain[4]
    at = 5 + (0 if fhd & 0x20 else 1)
    with_dict = plain[:4] + bytes([fhd | 1]) + plain[5:at] + b"\x07" + \
        plain[at:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict, 300)


FUZZ = r"""
import sys
import numpy as np
import zstandard
from meanflow_audio_codec_torch.training.orbax import zstd

rng = np.random.default_rng(0)
sources = [rng.standard_normal(20000).astype(np.float32).tobytes(),
           open(sys.argv[1], "rb").read()[:40000],
           (b"abcdefgh" * 3000 + rng.bytes(700)) * 3]
frames = [(zstandard.ZstdCompressor(level=level, write_checksum=True)
           .compress(s), len(s)) for s in sources for level in (-5, 1, 3, 19)]
frames.append((zstd.frame(sources[0]), len(sources[0])))
outcomes = {"raised": 0, "decoded": 0}
for i in range(int(sys.argv[2])):
    frame, size = frames[i % len(frames)]
    data = bytearray(frame)
    kind = i % 3
    if kind == 0:
        data = data[:int(rng.integers(0, len(data)))]
    elif kind == 1:
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(0, len(data)))
            data[at] ^= 1 << int(rng.integers(0, 8))
    else:
        data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
    cap = size if i % 4 else int(rng.integers(0, 2 * size))
    out = np.empty(cap, dtype=np.uint8)
    try:
        got = zstd.decompress_into(bytes(data), out)
        assert 0 <= got <= cap
        outcomes["decoded"] += 1
    except ValueError:
        outcomes["raised"] += 1
print(outcomes["raised"], outcomes["decoded"])
"""


def test_malformed_frames_raise_without_crashing():
    result = subprocess.run(
        [sys.executable, "-c", FUZZ, str(REPO / "README.md"), "20000"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    raised, decoded = map(int, result.stdout.split())
    assert raised + decoded == 20000 and raised > 17000
