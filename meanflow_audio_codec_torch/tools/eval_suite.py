"""One-process evaluation suite for a trained audio-codec run.

Counterpart of ``meanflow_audio_codec_torch/tools/eval_suite.py``, with its
passes and file names, against one workdir's latest checkpoint:

  1. held-out quality sweep on ``--family`` (default tonal), NFE
     ``--nfe`` (default 1 2 10 50 250), with warm inference timing;
  2. stored-format quality through the rate-aware ECSQ bitstream at each
     ``--latent-steps`` fraction (NFE 1, measured rANS kbps);
  3. stored-format quality at fixed 8-bit codes (NFE 1);
  4. cross-family generalization on each ``--cross-family`` (default
     rich), NFE 1 and 10.

Results land in the workdir as ``evaluation_results{label}{tag}.json``, one
file per pass. The models run on the card (``--device cuda``, the default):
the MDCT and IMDCT kernels tokenize and decode every pass.

    python -m meanflow_audio_codec_torch.tools.eval_suite \
        --workdir outputs/imf_frontier_v2 --label _step65k
"""

from __future__ import annotations

import argparse
from pathlib import Path

from meanflow_audio_codec_torch.tools.evaluate_all import evaluate_config


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workdir", type=Path, required=True,
                        help="run directory (uses its config.json + "
                             "latest checkpoint)")
    parser.add_argument("--label", type=str, default="",
                        help="suffix for result filenames, e.g. _step65k")
    parser.add_argument("--num-samples", type=int, default=64)
    parser.add_argument("--nfe", type=int, nargs="+",
                        default=[1, 2, 10, 50, 250])
    parser.add_argument("--family", type=str, default="tonal",
                        help="held-out family for the quality passes")
    parser.add_argument("--cross-family", type=str, nargs="*",
                        default=["rich"],
                        help="families for the generalization pass, one "
                             "NFE-[1,10] result file each (empty skips); "
                             "for a run trained on 'mixed' pass the three "
                             "constituents to get the per-family breakdown")
    parser.add_argument("--latent-steps", type=float, nargs="*",
                        default=[0.5],
                        help="ECSQ step fractions for the stored-format "
                             "pass (empty list skips)")
    parser.add_argument("--latent-bits", type=int, default=8,
                        help="fixed-width bits for the stored-format "
                             "pass (0 skips)")
    parser.add_argument("--timing-runs", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    config_path = args.workdir / "config.json"
    if not config_path.exists():
        raise SystemExit(f"no config.json under {args.workdir}")
    label = args.label

    def run(tag: str, **kwargs) -> None:
        name = f"evaluation_results{label}{tag}.json"
        print(f"=== pass {name} ===", flush=True)
        evaluate_config(config_path, num_samples=args.num_samples,
                        csv_path=None, results_name=name,
                        device=args.device, **kwargs)

    # 1. held-out quality sweep (the headline table)
    run("", nfe_list=args.nfe, synthetic_family=args.family,
        timing_runs=args.timing_runs)
    # 2. stored format: rate-aware ECSQ at each step fraction
    for step in args.latent_steps:
        run(f"_ecsq{step:g}", nfe_list=[1], synthetic_family=args.family,
            latent_step=step, timing_runs=0)
    # 3. stored format: fixed-width codes
    if args.latent_bits:
        run(f"_bits{args.latent_bits}", nfe_list=[1],
            synthetic_family=args.family, latent_bits=args.latent_bits,
            timing_runs=0)
    # 4. cross-family generalization / per-family breakdown
    for family in args.cross_family:
        run(f"_{family}", nfe_list=[1, 10],
            synthetic_family=family, timing_runs=0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
