"""Export listenable held-out WAV pairs from a trained codec run.

Counterpart of ``meanflow_audio_codec_torch/tools/export_samples.py``, with
its file names and sidecar. Two evidence families, on held-out draws at
``seed+1`` (the run's corpus, else its synthetic family), served by
:class:`~meanflow_audio_codec_torch.codec.AudioCodec` (EMA weights):

* ``heldout_{i}_{original,recon_nfe1}.wav`` — the float-latent round trip
  (``roundtrip``), the quality path the NFE tables score;
* ``bitstream_{i}_{original,recon_<kbps>kbps}.wav`` — the stored byte path
  (``encode_bytes`` -> rANS container -> ``decode_bytes``) at ``--bits``
  (or the rate-aware ECSQ knob ``--step-frac``), with the measured
  container bitrate in the file name;

and ``export_samples.json`` beside them. Runs on the card (``--device
cuda``, the default).

Usage:
    python -m meanflow_audio_codec_torch.tools.export_samples \
        --workdir outputs/imf_frontier_v2 --num-clips 4
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.data.audio import write_wav
from meanflow_audio_codec_torch.evaluators.audio_metrics import si_snr


def export_samples(workdir: Path, num_clips: int = 4, nfe: int = 1,
                   bits: int = 8, step_frac: float | None = None,
                   seconds: float | None = None,
                   skip_bitstream: bool = False,
                   out_dir: Path | None = None,
                   device: str = "cuda") -> dict:
    """Write WAV pairs + a JSON sidecar; returns the sidecar payload."""
    from meanflow_audio_codec_torch.data.audio import (
        TARGET_SAMPLE_RATE,
        synthetic_pipeline_for_family,
    )

    codec = AudioCodec.from_workdir(workdir, device=device)
    config = codec.config
    tok_cfg = config.tokenization_config
    frame_size = int(tok_cfg.get("frame_size", 65536))
    if seconds is not None:
        # round up to a whole number of frames so tokenize never pads oddly
        want = int(seconds * TARGET_SAMPLE_RATE)
        frame_size = max(frame_size,
                         ((want + frame_size - 1) // frame_size) * frame_size)

    if config.data_dir and Path(config.data_dir).exists():
        from meanflow_audio_codec_torch.data.audio import build_audio_pipeline
        pipeline = build_audio_pipeline(
            config.data_dir, seed=config.seed + 1, frame_size=frame_size,
            batch_size=num_clips)
    else:
        pipeline = synthetic_pipeline_for_family(
            tok_cfg.get("synthetic_family"), seed=config.seed + 1,
            frame_size=frame_size, batch_size=num_clips)
    clips = np.asarray(next(iter(pipeline)), dtype=np.float32)

    out_dir = Path(out_dir) if out_dir is not None else (
        Path(workdir) / "samples")
    out_dir.mkdir(parents=True, exist_ok=True)
    sidecar: dict = {"workdir": str(workdir), "nfe": nfe,
                     "num_clips": int(num_clips),
                     "frame_size": frame_size, "heldout": [],
                     "bitstream": []}

    recon = codec.roundtrip(clips, nfe=nfe).float().cpu().numpy()
    for i in range(num_clips):
        n = min(clips.shape[1], recon.shape[1])
        write_wav(out_dir / f"heldout_{i}_original.wav", clips[i, :n])
        write_wav(out_dir / f"heldout_{i}_recon_nfe{nfe}.wav", recon[i, :n])
        sidecar["heldout"].append(
            {"clip": i, "si_snr_db": si_snr(clips[i, :n], recon[i, :n])})

    if not skip_bitstream:
        seconds_per_clip = clips.shape[1] / float(TARGET_SAMPLE_RATE)
        for i in range(num_clips):
            data = codec.encode_bytes(clips[i:i + 1], bits=bits,
                                      step_frac=step_frac)
            kbps = len(data) * 8.0 / 1000.0 / seconds_per_clip
            out = codec.decode_bytes(data, nfe=nfe)[0].float().cpu().numpy()
            n = min(clips.shape[1], out.shape[0])
            tag = f"{kbps:.0f}kbps"
            write_wav(out_dir / f"bitstream_{i}_original.wav", clips[i, :n])
            write_wav(out_dir / f"bitstream_{i}_recon_{tag}.wav", out[:n])
            sidecar["bitstream"].append(
                {"clip": i, "kbps_measured": round(kbps, 1),
                 "bits": bits, "step_frac": step_frac,
                 "si_snr_db": si_snr(clips[i, :n], out[:n])})

    sidecar_path = out_dir / "export_samples.json"
    sidecar_path.write_text(json.dumps(sidecar, indent=2))
    for row in sidecar["heldout"]:
        print(f"heldout {row['clip']}: {row['si_snr_db']:+.2f} dB")
    for row in sidecar["bitstream"]:
        print(f"bitstream {row['clip']}: {row['si_snr_db']:+.2f} dB "
              f"@ {row['kbps_measured']} kbps")
    print(f"wrote {out_dir}")
    return sidecar


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Export held-out WAV pairs from a trained codec run")
    parser.add_argument("--workdir", type=Path, required=True)
    parser.add_argument("--num-clips", type=int, default=4)
    parser.add_argument("--nfe", type=int, default=1)
    parser.add_argument("--bits", type=int, default=8, choices=(4, 8, 16))
    parser.add_argument("--step-frac", type=float, default=None,
                        help="rate-aware ECSQ knob (overrides --bits)")
    parser.add_argument("--seconds", type=float, default=None,
                        help="minimum clip length (rounded up to whole "
                             "frames); default one frame_size")
    parser.add_argument("--skip-bitstream", action="store_true")
    parser.add_argument("--out-dir", type=Path, default=None,
                        help="output directory (default <workdir>/samples)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    export_samples(args.workdir, num_clips=args.num_clips, nfe=args.nfe,
                   bits=args.bits, step_frac=args.step_frac,
                   seconds=args.seconds, skip_bitstream=args.skip_bitstream,
                   out_dir=args.out_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
