"""Prefetch on/off ablation for the audio loader (host side).

Counterpart of ``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_prefetch.py``:
one-pass decode + frame of a synthetic WAV corpus through the *Python*
stage pipeline of ``data/audio`` (the native loader has its own producer
threads), at each prefetch depth. One JSON row per configuration::

    {"prefetch", "n_files", "frames", "sec", "frames_per_sec"}

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_prefetch
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

from meanflow_audio_codec_torch.data.audio import (
    audio_to_frames,
    glob_audio_files,
    load_audio_files,
)
from meanflow_audio_codec_torch.tools.benchmarks._timing import start
from meanflow_audio_codec_torch.tools.benchmarks.benchmark_pipeline_stages import (
    make_corpus,
)


def bench(data_dir: Path, prefetch: int, frame_size: int) -> dict:
    files = glob_audio_files(data_dir, seed=42)
    stream = load_audio_files(files, prefetch=prefetch, loop=False)
    stream = audio_to_frames(stream, frame_size, seed=42)
    t0 = time.perf_counter()
    n_frames = sum(1 for _ in stream)
    elapsed = time.perf_counter() - t0
    return {
        "prefetch": prefetch,
        "n_files": len(files),
        "frames": n_frames,
        "sec": round(elapsed, 4),
        "frames_per_sec": round(n_frames / elapsed, 1),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", type=Path, default=None,
                        help="existing corpus; default: synthetic tmp corpus")
    parser.add_argument("--frame-size", type=int, default=16384)
    parser.add_argument("--file-counts", type=int, nargs="+",
                        default=[10, 50])
    parser.add_argument("--prefetch-levels", type=int, nargs="+",
                        default=[0, 1, 2, 4])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'; the stages run on "
                             "the host either way")
    args = parser.parse_args(argv)
    start(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        for n_files in args.file_counts:
            if args.data_dir and Path(args.data_dir).exists():
                data_dir = Path(args.data_dir)
            else:
                data_dir = Path(tmp) / f"corpus_{n_files}"
                data_dir.mkdir()
                make_corpus(data_dir, n_files, seconds=1.0)
            for prefetch in args.prefetch_levels:
                print(json.dumps(bench(data_dir, prefetch, args.frame_size)),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
