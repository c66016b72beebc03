"""Codec CLI: compress a WAV file to a .macb bitstream and back.

Counterpart of ``meanflow_audio_codec_tpu/tools/codec_cli.py``, with its
arguments and printed lines; the .macb files are the same format, so either
package's CLI decodes the other's.

    python -m meanflow_audio_codec_torch.tools.codec_cli encode song.wav \\
        --workdir outputs/imf_frontier_v2 -o song.macb
    python -m meanflow_audio_codec_torch.tools.codec_cli decode song.macb \\
        --workdir outputs/imf_frontier_v2 -o recon.wav
    python -m meanflow_audio_codec_torch.tools.codec_cli info song.macb

Encode runs tokenize -> encoder -> per-frame scalar quantization -> rANS
coding (ops/latent_quant.py); decode runs the 1-NFE flow as the
dequantization post-filter. Input at any sample rate is resampled to 44.1
kHz. Decoded audio has the frame-implied length ``(nf-1)*hop + 2W``, up to
one window longer than the input. The codec runs on the card; ``--device
cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.data.audio import (
    TARGET_SAMPLE_RATE,
    load_audio_file,
    write_wav,
)
from meanflow_audio_codec_torch.ops.latent_quant import describe_bitstream


def _read_audio(path: Path):
    audio = load_audio_file(path, resample=True)  # any input rate
    if audio is None:
        raise SystemExit(f"cannot decode {path} (unsupported format)")
    return audio.T[None]  # (2, T) -> [1, T, 2]


def cmd_encode(args) -> int:
    codec = AudioCodec.from_workdir(args.workdir, device=args.device)
    audio = _read_audio(Path(args.input))
    data = codec.encode_bytes(audio, bits=args.bits,
                              step_frac=args.latent_step)
    out = Path(args.output or Path(args.input).with_suffix(".macb"))
    out.write_bytes(data)
    seconds = audio.shape[1] / float(TARGET_SAMPLE_RATE)
    kbps = len(data) * 8 / seconds / 1000.0
    print(f"{args.input}: {seconds:.1f}s -> {out} "
          f"({len(data)} bytes, {kbps:.1f} kbps)")
    return 0


def cmd_decode(args) -> int:
    codec = AudioCodec.from_workdir(args.workdir, device=args.device,
                                    quantized=args.quantized)
    data = Path(args.input).read_bytes()
    generator = torch.Generator(device=codec.device).manual_seed(args.seed)
    audio = codec.decode_bytes(data, nfe=args.nfe,
                               generator=generator)[0].cpu().numpy()
    out = Path(args.output or Path(args.input).with_suffix(".wav"))
    write_wav(out, audio)
    print(f"{args.input} -> {out} "
          f"({audio.shape[0] / float(TARGET_SAMPLE_RATE):.1f}s, "
          f"nfe={args.nfe})")
    return 0


def cmd_info(args) -> int:
    try:
        h = describe_bitstream(Path(args.input).read_bytes())
    except ValueError as exc:
        raise SystemExit(f"{args.input}: {exc}")
    print(f"{args.input}: MACB v{h['version']}, {h['bits']}-bit "
          f"{h['coding']} codes ({h['quantizer']}), batch={h['batch']} "
          f"frames={h['n_frames']} latent_dim={h['latent_dim']}, "
          f"{h['total_bytes']} bytes")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="codec_cli", description=__doc__,
                                     formatter_class=argparse
                                     .RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    enc = sub.add_parser("encode", help="WAV -> .macb bitstream")
    enc.add_argument("input")
    enc.add_argument("-o", "--output", default=None)
    enc.add_argument("--workdir", required=True,
                     help="trained run directory (config + checkpoints)")
    enc.add_argument("--bits", type=int, default=8, choices=(4, 8, 16))
    enc.add_argument("--latent-step", type=float, default=None,
                     help="rate-aware ECSQ mode (MACB v2): quantization "
                          "step as a fraction of the per-frame residual "
                          "standard deviation, the continuous rate knob; "
                          "overrides --bits")
    enc.set_defaults(fn=cmd_encode)

    dec = sub.add_parser("decode", help=".macb bitstream -> WAV")
    dec.add_argument("input")
    dec.add_argument("-o", "--output", default=None)
    dec.add_argument("--workdir", required=True)
    dec.add_argument("--nfe", type=int, default=1,
                     help="decode steps (1 = the native operating point)")
    dec.add_argument("--seed", type=int, default=0,
                     help="seed of the decode's noise generator")
    dec.add_argument("--quantized", action="store_true",
                     help="serve the decode int8 W8A8 (not ported yet: "
                          "raises)")
    dec.set_defaults(fn=cmd_decode)

    info = sub.add_parser("info", help="inspect a .macb header")
    info.add_argument("input")
    info.set_defaults(fn=cmd_info)

    for command in (enc, dec):
        command.add_argument("--device", default="cuda",
                             help="cuda (default) or cpu")

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
