"""Training CLI; counterpart of the repository's ``train.py``, with its flags.

    python -m meanflow_audio_codec_torch.train --config configs/X.json \
        [--workdir outputs/run] [--resume] [overrides ...]
    python -m meanflow_audio_codec_torch.train --dataset audio \
        --method improved_mean_flow --architecture convnet \
        --workdir outputs/run                     # fully flag-driven

Without ``--config`` the run starts from ``create_audio_config`` (``--dataset
audio``) or ``create_mnist_config`` (otherwise) with the flags' overrides;
``--method improved_mean_flow`` also sets ``use_improved_mean_flow``, and the
tokenization flags fold into ``dataset.tokenization_config``. Trains on the
card (``train_flow(device="cuda")``). Under ``torchrun`` each rank runs this
CLI and the run is sharded over the ranks (``training/trainer.py``):

    torchrun --nproc-per-node 4 -m meanflow_audio_codec_torch.train \
        --config configs/frontier_v2.json --workdir outputs/run
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch.distributed as dist

from meanflow_audio_codec_torch.configs import (
    CodecConfig,
    create_audio_config,
    create_mnist_config,
    load_config,
    merge_configs,
)
from meanflow_audio_codec_torch.training.trainer import train_flow


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a meanflow audio codec model on the card")
    p.add_argument("--config", type=Path, default=None,
                   help="JSON config file (v1 flat or v2 hierarchical)")
    p.add_argument("--workdir", type=Path, default=None,
                   help="run directory (overrides config)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest valid checkpoint")
    # flag-driven alternative to --config
    p.add_argument("--dataset", choices=["mnist", "audio"], default=None)
    p.add_argument("--data-dir", type=str, default=None,
                   help="directory of audio files to train on (synthetic "
                        "audio when it does not exist)")
    p.add_argument("--method", choices=["autoencoder", "flow_matching",
                                        "mean_flow", "improved_mean_flow"],
                   default=None)
    p.add_argument("--architecture", choices=["mlp", "mlp_mixer", "convnet",
                                              "simple_conv"], default=None)
    p.add_argument("--tokenization", choices=["mdct", "reshape"], default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--n-steps", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--noise-dimension", type=int, default=None)
    p.add_argument("--condition-dimension", type=int, default=None)
    p.add_argument("--latent-dimension", type=int, default=None)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--full-interval-proportion", type=float, default=None,
                   help="fraction of each batch trained at the exact "
                        "(t=1, r=0) pair that 1-NFE decode evaluates")
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
    p.add_argument("--window-size", type=int, default=None,
                   help="MDCT window size")
    p.add_argument("--coeff-scale", type=float, default=None,
                   help="divide MDCT tokens by this scale (flow conditioning)")
    p.add_argument("--pool-batches", type=int, default=None,
                   help="host replay-pool size for the synthetic audio source")
    p.add_argument("--device-pool-clips", type=int, default=None,
                   help="device-resident replay pool size in clips (0 "
                        "disables; default 1024 for synthetic audio, 0 for "
                        "a corpus)")
    p.add_argument("--architecture-options", type=str, default=None,
                   help='JSON dict of family-specific sizing, e.g. '
                        '\'{"channels": 128, "bottleneck_dim": 512}\'')
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="global-norm gradient clipping (stabilises bf16 JVP)")
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="linear LR warmup steps")
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default=None,
                   help="post-warmup LR decay (cosine decays to "
                        "lr-final-fraction * base-lr over n-steps)")
    p.add_argument("--lr-final-fraction", type=float, default=None)
    p.add_argument("--resample-audio", action="store_true",
                   help="polyphase-resample off-rate corpus files to "
                        "44.1 kHz instead of dropping them")
    p.add_argument("--skip-nonfinite", action="store_true",
                   help="drop NaN/inf updates (decided on the device)")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="train steps per call of the step function")
    return p


def config_from_args(args) -> CodecConfig:
    """The ``--config`` file, or the dataset's default config, with the
    flags' overrides merged in (the root CLI's ``config_from_args``)."""
    maps = {
        "base": {"batch_size": args.batch_size, "n_steps": args.n_steps,
                 "base_lr": args.base_lr, "weight_decay": args.weight_decay,
                 "seed": args.seed, "grad_clip_norm": args.grad_clip_norm,
                 "warmup_steps": args.warmup_steps,
                 "lr_schedule": args.lr_schedule,
                 "lr_final_fraction": args.lr_final_fraction},
        "model": {"architecture": args.architecture,
                  "noise_dimension": args.noise_dimension,
                  "condition_dimension": args.condition_dimension,
                  "latent_dimension": args.latent_dimension,
                  "num_blocks": args.num_blocks,
                  "architecture_options": (
                      json.loads(args.architecture_options)
                      if args.architecture_options else None)},
        "dataset": {"data_dir": args.data_dir,
                    "tokenization_strategy": args.tokenization,
                    "resample_audio": args.resample_audio or None},
        "method": {"method": args.method, "gamma": args.gamma,
                   "time_sampling_full_proportion":
                       args.full_interval_proportion},
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
                 for section, values in maps.items()}
    if args.method == "improved_mean_flow":
        overrides["method"]["use_improved_mean_flow"] = True
    tok_cfg = {name: value for name, value in (
        ("frame_size", args.frame_size), ("window_size", args.window_size),
        ("coeff_scale", args.coeff_scale),
        ("pool_batches", args.pool_batches),
        ("device_pool_clips", args.device_pool_clips)) if value is not None}
    if tok_cfg:
        overrides["dataset"]["tokenization_config"] = tok_cfg
    overrides = {k: v for k, v in overrides.items() if v}

    if args.config is not None:
        config = load_config(args.config)
        return merge_configs(config, overrides) if overrides else config
    factory = (create_audio_config if args.dataset == "audio"
               else create_mnist_config)
    return factory(**overrides)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.config is None and args.workdir is None:
        print("error: provide --config and/or --workdir", file=sys.stderr)
        return 2
    grouped = dist.is_initialized()
    train_flow(config_from_args(args), resume=args.resume)
    if not grouped and dist.is_initialized():  # the group the run formed
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
