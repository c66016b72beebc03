"""Probe: the codec bf16 against W8A8 int8 at the quality geometry, timed
in alternating turns in one process.

Counterpart of ``meanflow_audio_codec_tpu/tools/probes/probe_codec_ab.py``:
``benchmark_codec_geometry``'s codec call (MDCT -> encode -> one decoder
call -> IMDCT over 16 clips of 10 s of 48 kHz stereo) at
``ch512_s8_lift64_bn1024``, the bf16 model and the int8 one serving the
same seeded weights; ``--rounds`` rounds, each timing 5 calls of one then
of the other. One JSON row per (round, side), then the best of each and
their ratio::

    {"round", "quantized", "ms"}
    {"bf16_best_ms", "bf16_rtf", "int8_best_ms", "int8_rtf", "speedup"}

    python -m meanflow_audio_codec_torch.tools.probes.probe_codec_ab
"""

from __future__ import annotations

import argparse
import json

from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    Clock,
    start,
)
from meanflow_audio_codec_torch.tools.benchmarks.benchmark_codec_geometry import (
    CLIP_SECONDS,
    build_model,
    codec,
    seeded_audio,
    tokenizer,
)

CLIPS = 16
GEO = dict(num_blocks=8, channels=512, bottleneck_dim=1024, spatial=8,
           lift_channels=64)
CALLS = 5


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    tok = tokenizer()
    audio = seeded_audio(CLIPS, CLIP_SECONDS, device)
    models = {False: build_model(device, **GEO)}
    models[True] = build_model(device, quantized=True, **GEO)
    models[True].load_state_dict(models[False].state_dict(), strict=True)
    for model in models.values():
        codec(model, tok, audio)

    best = {q: float("inf") for q in models}
    for round_i in range(args.rounds):
        for q, model in models.items():
            with Clock(device) as clock:
                for _ in range(CALLS):
                    codec(model, tok, audio)
            wall = clock.wall / CALLS
            best[q] = min(best[q], wall)
            print(json.dumps({"round": round_i, "quantized": q,
                              "ms": round(wall * 1e3, 1)}), flush=True)
    secs = CLIPS * CLIP_SECONDS
    bf16, int8 = best[False], best[True]
    print(json.dumps({"bf16_best_ms": round(bf16 * 1e3, 1),
                      "bf16_rtf": round(secs / bf16),
                      "int8_best_ms": round(int8 * 1e3, 1),
                      "int8_rtf": round(secs / int8),
                      "speedup": round(bf16 / int8, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
