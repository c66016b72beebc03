"""Per-stage timing of the audio data pipeline (host side).

Counterpart of
``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_pipeline_stages.py``:
each stage of ``data/audio`` timed in isolation over a synthetic WAV
corpus (decode, framing, shuffle, batching, the composed Python pipeline)
and the native loader (``data/native``, ``native/dataloader.cpp``). One
JSON row per stage::

    {"stage", <unit>, "sec", "<unit>_per_sec"}

A native loader that does not build raises (no row is skipped).

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_pipeline_stages
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from meanflow_audio_codec_torch.data.audio import (
    audio_to_frames,
    batch,
    buffer_shuffle,
    build_audio_pipeline,
    glob_audio_files,
    load_audio_file,
    load_audio_files,
    write_wav,
)
from meanflow_audio_codec_torch.tools.benchmarks._timing import start


def make_corpus(out_dir: Path, num_files: int, seconds: float = 2.0) -> None:
    """``num_files`` seeded noise WAVs (stereo, 44.1 kHz, 0.4 peak); the
    corpus every data script times unless given ``--data-dir``."""
    rng = np.random.default_rng(0)
    rate = 44100
    for i in range(num_files):
        audio = rng.uniform(-0.4, 0.4,
                            (int(seconds * rate), 2)).astype(np.float32)
        write_wav(out_dir / f"bench_{i:04d}.wav", audio, rate)


def timed(stage: str, iterator, unit: str = "items") -> dict:
    t0 = time.perf_counter()
    n = sum(1 for _ in iterator)
    elapsed = time.perf_counter() - t0
    return {"stage": stage, unit: n, "sec": round(elapsed, 4),
            f"{unit}_per_sec": round(n / max(elapsed, 1e-9), 1)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", type=Path, default=None)
    parser.add_argument("--n-files", type=int, default=20)
    parser.add_argument("--frame-size", type=int, default=16384)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--buffer-size", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'; the stages run on "
                             "the host either way")
    args = parser.parse_args(argv)
    start(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        if args.data_dir and Path(args.data_dir).exists():
            data_dir = Path(args.data_dir)
        else:
            data_dir = Path(tmp)
            make_corpus(data_dir, args.n_files)
        files = glob_audio_files(data_dir, seed=42)

        # stage 1: raw decode (synchronous, isolates codec cost)
        print(json.dumps(timed(
            "decode", (load_audio_file(f) for f in files), unit="files")),
            flush=True)

        # pre-decode once so downstream stages measure only their own work
        decoded = [a for a in (load_audio_file(f) for f in files)
                   if a is not None]

        print(json.dumps(timed(
            "framing", audio_to_frames(iter(decoded), args.frame_size,
                                       seed=42), unit="frames")), flush=True)
        frames = list(audio_to_frames(iter(decoded), args.frame_size,
                                      seed=42))
        print(json.dumps(timed(
            "shuffle", buffer_shuffle(iter(frames), args.buffer_size,
                                      seed=42), unit="frames")), flush=True)
        print(json.dumps(timed(
            "batch", batch(buffer_shuffle(iter(frames), args.buffer_size,
                                          seed=42), args.batch_size),
            unit="batches")), flush=True)

        # composed pipelines, one pass
        print(json.dumps(timed(
            "pipeline_python",
            batch(buffer_shuffle(
                audio_to_frames(
                    load_audio_files(files, prefetch=2, loop=False),
                    args.frame_size, seed=42),
                args.buffer_size, seed=42), args.batch_size),
            unit="batches")), flush=True)
        print(json.dumps(timed(
            "pipeline_native",
            build_audio_pipeline(data_dir, frame_size=args.frame_size,
                                 batch_size=args.batch_size,
                                 buffer_size=args.buffer_size,
                                 loop=False, native=True),
            unit="batches")), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
