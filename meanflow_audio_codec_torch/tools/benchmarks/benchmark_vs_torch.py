"""Data-loader comparison against a PyTorch DataLoader pipeline (host side).

Counterpart of ``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_vs_torch.py``:
three loaders over the same WAV corpus and frame contract,

  1. the port's native C++ loader (``data/native``),
  2. the port's Python pipeline (``data/audio`` stages),
  3. a ``torch.utils.data.DataLoader`` over an ``IterableDataset`` doing
     the same decode + framing work.

One JSON row per loader, the JAX script's text line as fields, then the
native loader's rate over the DataLoader's::

    {"loader", "first_ms", "batches_per_sec", "msamples_per_sec"}
    {"native_vs_torch"}

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_vs_torch
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils.data import DataLoader, IterableDataset

from meanflow_audio_codec_torch.data.audio import (
    build_audio_pipeline,
    load_audio_file,
)
from meanflow_audio_codec_torch.tools.benchmarks._timing import start
from meanflow_audio_codec_torch.tools.benchmarks.benchmark_pipeline_stages import (
    make_corpus,
)


def bench_iterator(make_iter, warmup: int, timed: int) -> dict:
    t0 = time.perf_counter()
    iterator = make_iter()
    batch = next(iterator)
    first = time.perf_counter() - t0
    for _ in range(warmup):
        next(iterator)
    t0 = time.perf_counter()
    for _ in range(timed):
        batch = next(iterator)
    elapsed = time.perf_counter() - t0
    samples = batch.shape[0] * batch.shape[1] * batch.shape[2]
    return {"first_sec": first, "batches_per_sec": timed / elapsed,
            "samples_per_sec": timed * samples / elapsed}


def torch_loader(data_dir: Path, frame_size: int, batch_size: int):
    """DataLoader counterpart: decode + frame in an IterableDataset."""
    files = sorted(data_dir.glob("*.wav"))

    class FrameDataset(IterableDataset):
        def __iter__(self):
            rng = np.random.default_rng(0)
            while True:
                for path in files:
                    audio = load_audio_file(path)
                    if audio is None:
                        continue
                    channels, length = audio.shape
                    offset = int(rng.integers(0, frame_size))
                    total = -(-(offset + length) // frame_size) * frame_size
                    buf = np.zeros((channels, total), dtype=np.float32)
                    buf[:, offset:offset + length] = audio
                    frames = buf.reshape(channels, -1, frame_size)
                    for i in range(frames.shape[1]):
                        yield torch.from_numpy(
                            np.ascontiguousarray(frames[:, i, :].T))

    loader = DataLoader(FrameDataset(), batch_size=batch_size, num_workers=0)
    for batch in loader:
        yield batch.numpy()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", type=Path, default=None)
    parser.add_argument("--frame-size", type=int, default=65536)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--timed", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'; the loaders run on "
                             "the host either way")
    args = parser.parse_args(argv)
    start(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data_dir
        if data_dir is None or not Path(data_dir).exists():
            data_dir = Path(tmp)
            make_corpus(data_dir, 8, seconds=4.0)

        loaders = {
            "native C++": lambda: build_audio_pipeline(
                data_dir, frame_size=args.frame_size,
                batch_size=args.batch_size, native=True),
            "python pipeline": lambda: build_audio_pipeline(
                data_dir, frame_size=args.frame_size,
                batch_size=args.batch_size, native=False),
            "torch DataLoader": lambda: torch_loader(
                data_dir, args.frame_size, args.batch_size),
        }
        results = {}
        for name, make_iter in loaders.items():
            stats = bench_iterator(make_iter, args.warmup, args.timed)
            results[name] = stats
            print(json.dumps({
                "loader": name,
                "first_ms": round(stats["first_sec"] * 1e3, 1),
                "batches_per_sec": round(stats["batches_per_sec"], 2),
                "msamples_per_sec": round(stats["samples_per_sec"] / 1e6,
                                          2)}), flush=True)
        speedup = (results["native C++"]["samples_per_sec"]
                   / results["torch DataLoader"]["samples_per_sec"])
        print(json.dumps({"native_vs_torch": round(speedup, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
