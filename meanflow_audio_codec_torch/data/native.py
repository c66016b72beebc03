"""ctypes binding of the native audio loader ``native/dataloader.cpp``.

Counterpart of ``meanflow_audio_codec_tpu/data/native.py``: the same C
interface, the same decode calls and the same ``NativeAudioLoader`` (decode,
random-offset framing, the shuffle reservoir and threaded prefetch in C++),
yielding float32 ``[B, frame_size, C]`` batches as the Python stages of
``data/audio.py`` do. The repository's source is built with g++ (with
``-pthread``) at first use into the package's ``build/`` directory
(``ops/_build.py``). Unlike the JAX package, whose ``available()`` turns
False when the build fails and whose pipeline then takes the Python stages,
a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from meanflow_audio_codec_torch.ops import _build

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _loader_library() -> ctypes.CDLL:
    lib = _build.library("dataloader")
    lib.mac_loader_create.restype = ctypes.c_void_p
    lib.mac_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.mac_loader_next.restype = ctypes.c_int
    lib.mac_loader_next.argtypes = [ctypes.c_void_p, _FP]
    lib.mac_loader_frames_produced.restype = ctypes.c_uint64
    lib.mac_loader_frames_produced.argtypes = [ctypes.c_void_p]
    lib.mac_loader_files_skipped.restype = ctypes.c_uint64
    lib.mac_loader_files_skipped.argtypes = [ctypes.c_void_p]
    lib.mac_loader_destroy.restype = None
    lib.mac_loader_destroy.argtypes = [ctypes.c_void_p]
    for name in ("mac_decode_wav", "mac_decode_audio"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, _FP, ctypes.c_long, _IP, _IP]
    return lib


def available() -> bool:
    """True once the loader library is built and loaded; a failed build
    raises ``RuntimeError`` with g++'s output."""
    return _loader_library() is not None


def load_error() -> str | None:
    """The build's error, or None when the library builds and loads."""
    try:
        _loader_library()
    except (RuntimeError, OSError) as exc:
        return str(exc)
    return None


def _wav_sample_bound(path: Path) -> int | None:
    """The interleaved-sample count the container's header gives, or None.

    Scans WAV/AIFF chunks for bits per sample and the payload's byte size
    (a byte count alone over-allocates 8x for 16-bit PCM), or reads
    STREAMINFO's total-samples field of a FLAC file (a compressed payload's
    bytes say nothing of its decoded size)."""
    try:
        with open(path, "rb") as f:
            magic = f.read(12)[:4]
            if magic == b"RIFF":
                order, fmt_id, data_id, bits_off = "little", b"fmt ", b"data", 14
            elif magic == b"FORM":
                order, fmt_id, data_id, bits_off = "big", b"COMM", b"SSND", 6
            elif magic == b"fLaC":
                # STREAMINFO is mandatory and first: a 4-byte block header,
                # then 34 bytes; channels-1 at bit 100, total samples (36
                # bits) at bit 108
                f.seek(4)
                block = f.read(4 + 34)
                if len(block) < 38 or block[0] & 0x7F != 0:
                    return None
                si = block[4:]
                channels = ((si[12] >> 1) & 0x7) + 1
                total = ((si[13] & 0xF) << 32) | int.from_bytes(
                    si[14:18], "big")
                return max(total * channels, 64) if total else None
            else:
                return None
            bytes_per = None
            for _ in range(64):  # a bounded chunk scan
                head = f.read(8)
                if len(head) < 8:
                    return None
                size = int.from_bytes(head[4:8], order)
                if head[:4] == fmt_id and size >= bits_off + 2:
                    fmt = f.read(min(size, 4096))
                    bits = int.from_bytes(fmt[bits_off:bits_off + 2], order)
                    if bits not in (8, 16, 24, 32):
                        return None
                    bytes_per = bits // 8
                    f.seek(max(size - 4096, 0) + (size & 1), 1)
                elif head[:4] == data_id and bytes_per:
                    return max(size // bytes_per, 64)
                else:
                    f.seek(size + (size & 1), 1)
    except OSError:
        return None
    return None


def decode_wav_native(path: Path | str,
                      max_samples: int | None = None
                      ) -> tuple[np.ndarray, int] | None:
    """Decode one WAV, AIFF/AIFC or FLAC file -> ((C, T) float32, rate), or
    None when the decoder rejects it.

    ``max_samples`` defaults to the sample count of the container's header
    (else the file's byte size, at most 256 Mi samples), so the scratch
    buffer is the payload's size.
    """
    lib = _loader_library()
    if max_samples is None:
        max_samples = _wav_sample_bound(Path(path))
        if max_samples is None:
            try:
                max_samples = min(max(Path(path).stat().st_size, 64), 1 << 28)
            except OSError:
                return None
    buf = np.empty(max_samples, dtype=np.float32)
    channels = ctypes.c_int()
    rate = ctypes.c_int()
    n = lib.mac_decode_audio(str(path).encode(), buf.ctypes.data_as(_FP),
                             max_samples, ctypes.byref(channels),
                             ctypes.byref(rate))
    if n < 0:
        return None
    interleaved = buf[:n].reshape(-1, channels.value)
    return np.ascontiguousarray(interleaved.T), rate.value


#: the container-sniffing decode (WAV, AIFF/AIFC or FLAC), the same contract
decode_audio_native = decode_wav_native


class NativeAudioLoader:
    """The threaded native loader, yielding ``[B, frame_size, C]`` batches.

    The C++ side shuffles the files with the seed, gives producer thread i
    the seed ``seed + i + 1`` for its framing offsets and draws from the
    reservoir with its own generator; which frames a draw finds depends on
    how far the producers got, so only a filled reservoir gives the same
    batches run after run.
    """

    def __init__(self, files: list[Path | str], frame_size: int,
                 channels: int = 2, batch_size: int = 32,
                 buffer_frames: int = 64, n_threads: int = 2,
                 target_rate: int = 44100, seed: int = 0,
                 loop: bool = True):
        self._handle = None
        if not files:
            raise ValueError("no input files")
        lib = _loader_library()
        self._lib = lib
        self.frame_size = frame_size
        self.channels = channels
        self.batch_size = batch_size
        encoded = [str(f).encode() for f in files]
        # the C++ side copies the paths before create returns
        paths = (ctypes.c_char_p * len(encoded))(*encoded)
        self._handle = lib.mac_loader_create(
            paths, len(encoded), frame_size, channels, batch_size,
            buffer_frames, n_threads, target_rate, seed, int(loop))
        if not self._handle:
            raise RuntimeError("mac_loader_create failed")
        self._out = np.empty((batch_size, frame_size, channels),
                             dtype=np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        n = self._lib.mac_loader_next(self._handle,
                                      self._out.ctypes.data_as(_FP))
        if n < self.batch_size:
            raise StopIteration
        return self._out.copy()

    def _count(self, read) -> int:
        if not self._handle:
            raise ValueError("the loader is closed")
        return int(read(self._handle))

    @property
    def frames_produced(self) -> int:
        return self._count(self._lib.mac_loader_frames_produced)

    @property
    def files_skipped(self) -> int:
        return self._count(self._lib.mac_loader_files_skipped)

    def close(self) -> None:
        """Stop and join the producer threads and free the loader."""
        if self._handle:
            self._lib.mac_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
