"""Audio loader benchmark (host side): cold-start latency and steady-state
throughput of the streaming pipeline, prefetch 0, 2 and 4.

Counterpart of
``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_audio_loader.py``
over ``data/audio.build_audio_pipeline`` (the native loader for a WAV
corpus). One JSON row per prefetch depth, the JAX script's text line as
fields::

    {"prefetch", "first_batch_ms", "batches_per_sec", "msamples_per_sec"}

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_audio_loader
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

from meanflow_audio_codec_torch.data.audio import build_audio_pipeline
from meanflow_audio_codec_torch.tools.benchmarks._timing import start
from meanflow_audio_codec_torch.tools.benchmarks.benchmark_pipeline_stages import (
    make_corpus,
)


def bench(data_dir: Path, frame_size: int, batch_size: int, prefetch: int,
          warmup: int, timed: int) -> dict:
    pipeline = build_audio_pipeline(data_dir, frame_size=frame_size,
                                    batch_size=batch_size, prefetch=prefetch,
                                    buffer_size=8)
    t0 = time.perf_counter()
    next(pipeline)
    first_latency = time.perf_counter() - t0
    for _ in range(warmup):
        next(pipeline)
    t0 = time.perf_counter()
    for _ in range(timed):
        batch = next(pipeline)
    elapsed = time.perf_counter() - t0
    samples_per_batch = batch.shape[0] * batch.shape[1] * batch.shape[2]
    return {
        "first_batch_sec": first_latency,
        "batches_per_sec": timed / elapsed,
        "samples_per_sec": timed * samples_per_batch / elapsed,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", type=Path, default=None)
    parser.add_argument("--frame-size", type=int, default=65536)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--timed", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'; the loader runs on "
                             "the host either way")
    args = parser.parse_args(argv)
    start(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data_dir
        if data_dir is None or not Path(data_dir).exists():
            data_dir = Path(tmp)
            make_corpus(data_dir, 8, seconds=4.0)
        for prefetch in (0, 2, 4):
            stats = bench(data_dir, args.frame_size, args.batch_size,
                          prefetch, args.warmup, args.timed)
            print(json.dumps({
                "prefetch": prefetch,
                "first_batch_ms": round(stats["first_batch_sec"] * 1e3, 1),
                "batches_per_sec": round(stats["batches_per_sec"], 2),
                "msamples_per_sec": round(stats["samples_per_sec"] / 1e6,
                                          2)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
