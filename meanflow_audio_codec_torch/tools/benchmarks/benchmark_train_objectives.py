"""Objective throughput benchmark: steps/s and FLOPs per step for each of
AE / FM / MF / iMF on the same model, plus the convergence signal (the MSE
at the first and last timed step).

Counterpart of
``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_train_objectives.py``:
the MLP conditional flow (condition 128, latent 256, bf16 compute, seeded
random weights), each objective from the same initial weights through
``training/train_step.make_train_step`` with optax-style AdamW at 1e-4 on
one fixed batch; FLOPs per step by ``training/profiling.estimate_step_flops``
(one probe step), one warm-up step, then ``--steps`` steps ended by
``torch.cuda.synchronize``. One JSON row per objective, the JAX script's
text line as fields::

    {"objective", "batch", "dim", "blocks", "steps_per_sec",
     "gflop_per_step", "mse_first", "mse_last"}

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_train_objectives
"""

from __future__ import annotations

import argparse

import torch

from meanflow_audio_codec_torch.evaluators.performance import force_completion
from meanflow_audio_codec_torch.models.mlp_flow import ConditionalFlow
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    Clock,
    start,
    sweep,
)
from meanflow_audio_codec_torch.training.objectives import (
    AutoencoderObjective,
    FlowMatchingObjective,
    ImprovedMeanFlowObjective,
    MeanFlowObjective,
)
from meanflow_audio_codec_torch.training.profiling import estimate_step_flops
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

OBJECTIVES = {
    "autoencoder": AutoencoderObjective,
    "flow_matching": FlowMatchingObjective,
    "mean_flow": MeanFlowObjective,
    "improved_mean_flow": ImprovedMeanFlowObjective,
}


def bench_objective(name: str, data: torch.Tensor, blocks: int, steps: int,
                    device: torch.device) -> dict:
    batch, dim = data.shape
    # every objective from the same weights (a generator seeded 0), through
    # optax.adamw(1e-4)
    state = create_train_state(
        ConditionalFlow(dim, 128, blocks, 256, compute_dtype=torch.bfloat16),
        torch.Generator().manual_seed(0), batch, 1e-4, device=device)
    step = make_train_step(OBJECTIVES[name]())
    gen = torch.Generator(device).manual_seed(2)
    flops = estimate_step_flops(lambda: step(state, data, generator=gen))
    state, metrics = step(state, data, generator=gen)
    force_completion(metrics["loss"])
    gen = torch.Generator(device).manual_seed(3)
    mses = []
    with Clock(device) as clock:
        for _ in range(steps):
            state, metrics = step(state, data, generator=gen)
            mses.append(metrics.get("mse", metrics["loss"]))
    wall = clock.wall / steps
    return {"objective": name, "batch": batch, "dim": dim, "blocks": blocks,
            "steps_per_sec": round(1 / wall, 2),
            "gflop_per_step": round(flops / 1e9, 1) if flops else None,
            "mse_first": round(float(mses[0]), 4),
            "mse_last": round(float(mses[-1]), 4)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--noise-dim", type=int, default=784)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--blocks", type=int, default=8)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)

    data = torch.randn((args.batch, args.noise_dim),
                       generator=torch.Generator(device).manual_seed(1),
                       device=device)
    return sweep(({"objective": name}, lambda name=name: bench_objective(
        name, data, args.blocks, args.steps, device))
        for name in OBJECTIVES)


if __name__ == "__main__":
    raise SystemExit(main())
