"""Write an on-disk audio corpus from the synthetic families.

Counterpart of ``meanflow_audio_codec_tpu/tools/make_corpus.py``, with its
arguments, file names and bytes: N stereo clips of a synthetic family
(``data/audio.py``) as 16-bit WAV or FLAC files, a file corpus for
``dataset.data_dir`` training. A FLAC corpus runs the native loader's
compressed-container decoder.

    python -m meanflow_audio_codec_torch.tools.make_corpus \\
        --out-dir /tmp/corpus --family mixed --num-clips 16 \\
        --seconds 4.46 --format flac
"""

from __future__ import annotations

import argparse
from pathlib import Path

from meanflow_audio_codec_torch.data.audio import (
    SYNTHETIC_FAMILIES,
    TARGET_SAMPLE_RATE,
    synthetic_pipeline_for_family,
    write_wav,
)
from meanflow_audio_codec_torch.data.flac_write import write_flac_pcm16

WRITERS = {"wav": write_wav, "flac": write_flac_pcm16}


def make_corpus(out_dir: Path, family: str = "tonal", num_clips: int = 64,
                seconds: float = 4.46, fmt: str = "wav",
                sample_rate: int = TARGET_SAMPLE_RATE,
                seed: int = 0) -> list[Path]:
    """Write ``num_clips`` stereo clips; returns their paths."""
    if fmt not in WRITERS:
        raise ValueError(f"format must be wav or flac, got {fmt!r}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    frame_size = int(seconds * sample_rate)
    batch = min(num_clips, 16)  # the generator's batch bounds host memory
    stream = synthetic_pipeline_for_family(
        family, seed=seed, frame_size=frame_size, batch_size=batch,
        sample_rate=sample_rate)
    paths: list[Path] = []
    for clips in stream:  # [B, T, 2]
        for clip in clips:
            path = out_dir / f"{family}_{len(paths):05d}.{fmt}"
            WRITERS[fmt](path, clip, sample_rate)
            paths.append(path)
            if len(paths) >= num_clips:
                return paths
    return paths


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out-dir", type=Path, required=True)
    parser.add_argument("--family", default="tonal",
                        choices=sorted(SYNTHETIC_FAMILIES))
    parser.add_argument("--num-clips", type=int, default=64)
    parser.add_argument("--seconds", type=float, default=4.46)
    parser.add_argument("--format", dest="fmt", default="wav",
                        choices=tuple(WRITERS))
    parser.add_argument("--sample-rate", type=int,
                        default=TARGET_SAMPLE_RATE)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    paths = make_corpus(args.out_dir, args.family, args.num_clips,
                        args.seconds, args.fmt, args.sample_rate, args.seed)
    total_bytes = sum(p.stat().st_size for p in paths)
    print(f"Wrote {len(paths)} {args.fmt} clips ({args.family} family, "
          f"{args.seconds:.2f}s @ {args.sample_rate} Hz) to {args.out_dir} "
          f"({total_bytes / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
