"""Audio decoder-backend comparison (host side).

Counterpart of
``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_audio_decoders.py``,
across the decode backends the port can route to: the stdlib ``wave``
parser (``data/audio``), the native C++ parser (``native/dataloader.cpp``
through ``data/native``; WAV and FLAC), and the optional third-party
decoders present in the environment (minimp3py, soundfile, librosa, the
SDL mixer through pygame), each gated on import. One JSON row per backend::

    {"backend", "files", "sec", "files_per_sec", "msamples_per_sec",
     "samples_per_file"}

or ``{"backend", "skipped": reason}`` when a backend has no files of its
type or does not import.

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_audio_decoders
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np

from meanflow_audio_codec_torch.data.audio import glob_audio_files
from meanflow_audio_codec_torch.tools.benchmarks._timing import start
from meanflow_audio_codec_torch.tools.benchmarks.benchmark_pipeline_stages import (
    make_corpus,
)


def _decode_stdlib_wave(path: Path) -> int:
    from meanflow_audio_codec_torch.data.audio import _decode_wav
    audio, _ = _decode_wav(path)
    return audio.size


def _decode_native_cpp(path: Path) -> int:
    from meanflow_audio_codec_torch.data.native import decode_wav_native
    decoded = decode_wav_native(path)
    if decoded is None:
        raise RuntimeError(f"the native decoder rejected {path.name}")
    return decoded[0].size


def _decode_minimp3(path: Path) -> int:
    import minimp3py
    data, _ = minimp3py.read(str(path))
    return int(np.asarray(data).size)


def _decode_sdl_mixer(path: Path) -> int:
    from meanflow_audio_codec_torch.data.audio import _decode_mp3_sdl
    decoded = _decode_mp3_sdl(path)
    if decoded is None:
        raise RuntimeError("SDL_mixer (pygame) unavailable")
    return decoded[0].size


def in_package_mp3() -> Path | None:
    """A real MP3 that ships with pygame (its example data), used when a
    corpus has no .mp3 files: no encoder here writes MP3."""
    spec = importlib.util.find_spec("pygame")
    if spec is None or spec.origin is None:
        return None
    path = Path(spec.origin).parent / "examples" / "data" / "house_lo.mp3"
    return path if path.exists() else None


def _decode_soundfile(path: Path) -> int:
    import soundfile
    data, _ = soundfile.read(str(path), dtype="float32")
    return int(np.asarray(data).size)


def _decode_librosa(path: Path) -> int:
    import librosa
    data, _ = librosa.load(str(path), sr=None, mono=False)
    return int(np.asarray(data).size)


#: backend name -> (decode fn, file suffix it handles)
BACKENDS: dict[str, tuple[Callable[[Path], int], str]] = {
    "stdlib_wave": (_decode_stdlib_wave, ".wav"),
    "native_cpp": (_decode_native_cpp, ".wav"),
    "native_cpp_flac": (_decode_native_cpp, ".flac"),
    "soundfile": (_decode_soundfile, ".wav"),
    "librosa": (_decode_librosa, ".wav"),
    "minimp3py": (_decode_minimp3, ".mp3"),
    "sdl_mixer": (_decode_sdl_mixer, ".mp3"),
}


def bench_backend(name: str, files: list[Path], repeats: int) -> dict:
    fn, suffix = BACKENDS[name]
    files = [f for f in files if f.suffix.lower() == suffix]
    if not files:
        return {"backend": name, "skipped": f"no {suffix} files"}
    try:
        samples = fn(files[0])  # warm caches / fail fast on missing deps
    except Exception as exc:  # an optional backend that is not installed
        return {"backend": name, "skipped": f"{type(exc).__name__}: {exc}"}
    t0 = time.perf_counter()
    total = 0
    for _ in range(repeats):
        for f in files:
            total += fn(f)
    elapsed = time.perf_counter() - t0
    n = repeats * len(files)
    return {"backend": name, "files": n, "sec": round(elapsed, 4),
            "files_per_sec": round(n / max(elapsed, 1e-9), 1),
            "msamples_per_sec": round(total / max(elapsed, 1e-9) / 1e6, 2),
            "samples_per_file": samples}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", type=Path, default=None,
                        help="existing corpus (default: synthetic WAVs)")
    parser.add_argument("--n-files", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--backends", nargs="+", default=list(BACKENDS),
                        choices=list(BACKENDS))
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'; decoding runs on "
                             "the host either way")
    args = parser.parse_args(argv)
    start(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        if args.data_dir and Path(args.data_dir).exists():
            data_dir = Path(args.data_dir)
        else:
            data_dir = Path(tmp)
            make_corpus(data_dir, args.n_files, seconds=args.seconds)
            if "native_cpp_flac" in args.backends:
                from meanflow_audio_codec_torch.tools.make_corpus import (
                    make_corpus as make_family_corpus)
                make_family_corpus(data_dir, family="tonal",
                                   num_clips=args.n_files,
                                   seconds=args.seconds, fmt="flac")
        files = glob_audio_files(data_dir, seed=0)
        mp3 = in_package_mp3()
        if not any(f.suffix == ".mp3" for f in files) and mp3 is not None:
            files = files + [mp3]
        for name in args.backends:
            print(json.dumps(bench_backend(name, files, args.repeats)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
