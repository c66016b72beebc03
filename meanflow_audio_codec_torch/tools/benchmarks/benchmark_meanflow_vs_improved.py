"""Mean-flow against improved-mean-flow training dynamics.

Counterpart of
``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_meanflow_vs_improved.py``:
the same tiny conditional flow (f32, 4 blocks, condition 32, latent 16)
trained with each objective through ``training/train_step.make_train_step``
(Adam at 1e-3) on a fixed low-rank synthetic dataset, with loss/MSE
trajectories (eight logged steps, read on the host as the JAX script reads
them) and steps/s. One JSON row per (objective, logged step), then one per
objective with its rate::

    {"objective", "step", "loss", "mse"}
    {"objective", "steps_per_sec"}

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_meanflow_vs_improved
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from meanflow_audio_codec_torch.models.mlp_flow import ConditionalFlow
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    Clock,
    start,
)
from meanflow_audio_codec_torch.training.objectives import (
    FlowMatchingObjective,
    ImprovedMeanFlowObjective,
    MeanFlowObjective,
)
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)
from meanflow_audio_codec_torch.training.train_step import make_train_step

OBJECTIVES = {
    "flow_matching": FlowMatchingObjective,
    "mean_flow": MeanFlowObjective,
    "improved_mean_flow": ImprovedMeanFlowObjective,
}


def run_objective(name: str, steps: int, batch: int, dim: int,
                  seed: int = 0,
                  device: str | torch.device = "cuda") -> list[dict]:
    device = torch.device(device)
    objective = OBJECTIVES[name]()
    # optax.adam(1e-3): AdamW without weight decay
    state = create_train_state(ConditionalFlow(dim, 32, 4, 16),
                               torch.Generator().manual_seed(seed), batch,
                               1e-3, weight_decay=0.0, device=device)
    step = make_train_step(objective)
    gen = torch.Generator(device).manual_seed(seed)

    # fixed low-rank dataset: learnable by the tiny model
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((4, dim)).astype(np.float32)
    rows = []
    log_every = max(1, steps // 8)
    with Clock(device) as clock:
        for i in range(steps):
            coeffs = rng.standard_normal((batch, 4)).astype(np.float32)
            x = torch.from_numpy(coeffs @ basis).to(device)
            state, metrics = step(state, x, generator=gen)
            if (i + 1) % log_every == 0 or i == 0:
                rows.append({"objective": name, "step": i + 1,
                             "loss": round(float(metrics["loss"]), 5),
                             "mse": round(float(metrics["mse"]), 5)})
    rows.append({"objective": name,
                 "steps_per_sec": round(steps / clock.wall, 2)})
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--objectives", nargs="+",
                        default=list(OBJECTIVES))
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    for name in args.objectives:
        for row in run_objective(name, args.steps, args.batch, args.dim,
                                 device=device):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
