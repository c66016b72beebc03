"""Dataset downloader; counterpart of
``meanflow_audio_codec_tpu/tools/download_wavegen.py``: HuggingFace
WaveGenAI/youtube-cc-by-music metadata -> yt-dlp -> 44.1 kHz MP3s.

Downloading needs the optional ``datasets`` and ``yt_dlp`` packages and
network access; without the packages it raises a clear ``ImportError``.
``--synthesize`` writes deterministic WAV clips instead (the JAX tool's
bytes, through the port's own ``write_wav``), so the audio pipeline has a
local corpus to exercise:

    python -m meanflow_audio_codec_torch.tools.download_wavegen \
        --synthesize --out-dir corpus --num-files 8
"""

from __future__ import annotations

import argparse
from pathlib import Path

DATASET_ID = "WaveGenAI/youtube-cc-by-music"
MAX_DURATION_SEC = 30 * 60  # 30-minute cap, as in the reference


def download(out_dir: Path, limit: int | None = None) -> int:
    try:
        from datasets import load_dataset  # noqa: F401
        import yt_dlp  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "downloading requires the optional 'datasets' and 'yt_dlp' "
            "packages plus network egress; use --synthesize for a local "
            "test corpus") from exc
    from datasets import load_dataset
    import yt_dlp

    out_dir.mkdir(parents=True, exist_ok=True)
    existing = {p.stem for p in out_dir.glob("*.mp3")}
    count = 0
    stream = load_dataset(DATASET_ID, split="train", streaming=True)
    options = {
        "format": "bestaudio/best",
        "outtmpl": str(out_dir / "%(id)s.%(ext)s"),
        "postprocessors": [{"key": "FFmpegExtractAudio",
                            "preferredcodec": "mp3",
                            "preferredquality": "128"}],
        "postprocessor_args": ["-ar", "44100"],
        "quiet": True,
    }
    with yt_dlp.YoutubeDL(options) as ydl:
        for row in stream:
            if limit is not None and count >= limit:
                break
            video_id = row.get("id") or row.get("video_id")
            duration = row.get("duration") or 0
            if not video_id or video_id in existing:
                continue
            if duration and duration > MAX_DURATION_SEC:
                continue
            try:
                ydl.download([f"https://www.youtube.com/watch?v={video_id}"])
                count += 1
            except Exception as exc:
                print(f"skip {video_id}: {exc}")
    return count


def synthesize(out_dir: Path, num_files: int = 8,
               seconds: float = 5.0) -> int:
    """Write deterministic WAV clips as a stand-in corpus."""
    import numpy as np
    from meanflow_audio_codec_torch.data.audio import write_wav

    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    rate = 44100
    t = np.arange(int(seconds * rate)) / rate
    for i in range(num_files):
        freqs = rng.uniform(80, 2000, size=3)
        amps = rng.dirichlet(np.ones(3))
        left = sum(a * np.sin(2 * np.pi * f * t)
                   for a, f in zip(amps, freqs)).astype(np.float32)
        right = np.roll(left, rng.integers(0, 400))
        write_wav(out_dir / f"synthetic_{i:03d}.wav",
                  np.stack([left, right], axis=-1) * 0.5, rate)
    return num_files


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Fetch the wavegen corpus")
    parser.add_argument("--out-dir", type=Path,
                        default=Path.home() / "datasets" / "wavegen")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--synthesize", action="store_true",
                        help="write a deterministic local WAV corpus instead")
    parser.add_argument("--num-files", type=int, default=8)
    args = parser.parse_args(argv)
    if args.synthesize:
        n = synthesize(args.out_dir, num_files=args.num_files)
        print(f"Wrote {n} synthetic WAV files to {args.out_dir}")
        return 0
    n = download(args.out_dir, limit=args.limit)
    print(f"Downloaded {n} files to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
