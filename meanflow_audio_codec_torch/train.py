"""Config-driven training CLI; counterpart of the repository's ``train.py``.

    python -m meanflow_audio_codec_torch.train --config configs/X.json \
        [--workdir outputs/run] [--resume] [--n-steps N] ...

Trains on the card (``train_flow(device="cuda")``). The flags it honours
have the names and meanings of the root CLI's; the root CLI's other flags
(the flag-driven config without ``--config``, the model and optimiser
overrides, disk corpora) are refused with a message naming the ROADMAP.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from meanflow_audio_codec_torch.configs import load_config, merge_configs
from meanflow_audio_codec_torch.training.trainer import train_flow

#: flags of the root CLI the port does not honour yet
UNPORTED_FLAGS = (
    "--dataset", "--data-dir", "--method", "--architecture", "--tokenization",
    "--base-lr", "--weight-decay", "--noise-dimension",
    "--condition-dimension", "--latent-dimension", "--num-blocks", "--gamma",
    "--full-interval-proportion", "--window-size", "--coeff-scale",
    "--architecture-options", "--grad-clip-norm", "--warmup-steps",
    "--lr-schedule", "--lr-final-fraction", "--resample-audio")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a meanflow audio codec model on the card")
    p.add_argument("--config", type=Path, default=None,
                   help="JSON config file (v2 hierarchical)")
    p.add_argument("--workdir", type=Path, default=None,
                   help="run directory (overrides config)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest valid checkpoint")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--n-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sample-every", type=int, default=None)
    p.add_argument("--sample-steps", type=int, default=None)
    p.add_argument("--sample-seed", type=int, default=None)
    p.add_argument("--checkpoint-step", type=int, default=None)
    p.add_argument("--max-checkpoints-to-keep", type=int, default=None)
    p.add_argument("--ema-decay", type=float, default=None,
                   help="model-weight EMA decay (samplers prefer EMA params)")
    p.add_argument("--precision", choices=["float32", "bfloat16", "mixed"],
                   default=None)
    p.add_argument("--frame-size", type=int, default=None,
                   help="audio frame size in samples")
    p.add_argument("--pool-batches", type=int, default=None,
                   help="host replay-pool size for the synthetic audio source")
    p.add_argument("--device-pool-clips", type=int, default=None,
                   help="device-resident replay pool size in clips (0 "
                        "disables; default 1024)")
    p.add_argument("--skip-nonfinite", action="store_true",
                   help="drop NaN/inf updates (decided on the device)")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="train steps per call of the step function")
    return p


def config_from_args(args):
    """The ``--config`` file with the flags' overrides merged in."""
    overrides: dict = {
        "base": {"batch_size": args.batch_size, "n_steps": args.n_steps,
                 "seed": args.seed},
        "training": {"workdir": str(args.workdir) if args.workdir else None,
                     "sample_every": args.sample_every,
                     "sample_steps": args.sample_steps,
                     "sample_seed": args.sample_seed,
                     "checkpoint_step": args.checkpoint_step,
                     "max_checkpoints_to_keep": args.max_checkpoints_to_keep,
                     "ema_decay": args.ema_decay},
        "tpu": {"precision": args.precision,
                "skip_nonfinite_updates": args.skip_nonfinite or None,
                "steps_per_call": args.steps_per_call},
    }
    overrides = {section: {k: v for k, v in values.items() if v is not None}
                 for section, values in overrides.items()}
    tok_cfg = {k: v for k, v in (("frame_size", args.frame_size),
                                 ("pool_batches", args.pool_batches),
                                 ("device_pool_clips", args.device_pool_clips))
               if v is not None}
    if tok_cfg:
        overrides["dataset"] = {"tokenization_config": tok_cfg}
    return merge_configs(load_config(args.config),
                         {k: v for k, v in overrides.items() if v})


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    refused = [a.split("=")[0] for a in unknown
               if a.split("=")[0] in UNPORTED_FLAGS]
    if refused:
        print(f"error: {', '.join(refused)} not ported yet: the port's CLI "
              "takes --config and the flags its --help lists (ROADMAP "
              "items 7, 9a, 10, 17)", file=sys.stderr)
        return 2
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.config is None:
        print("error: provide --config (the flag-driven config is not "
              "ported yet, ROADMAP item 10)", file=sys.stderr)
        return 2
    train_flow(config_from_args(args), resume=args.resume)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
