"""Sampler latency benchmark: Heun against dual-time across the NFE sweep
(the evaluation harness's NFE 1, 10, 50, 250).

Counterpart of ``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_sampler.py``:
the MLP conditional flow (8 blocks, condition 128, latent 256, bf16
compute, seeded random weights) sampled from one fixed start noise through
``ops/sampling.sample`` (two model calls a step) and ``sample_dual_time``
(one), one warm-up call, then 5 calls ended by ``torch.cuda.synchronize``.
One JSON row per (NFE, sampler), the JAX script's text line as fields::

    {"nfe", "sampler", "batch", "ms_per_batch", "ms_per_sample"}

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_sampler
"""

from __future__ import annotations

import argparse

import torch

from meanflow_audio_codec_torch.models.factories import init_weights
from meanflow_audio_codec_torch.models.mlp_flow import ConditionalFlow
from meanflow_audio_codec_torch.ops.sampling import sample, sample_dual_time
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    start,
    sweep,
    time_calls,
)

SAMPLERS = {"heun": sample, "dual_time": sample_dual_time}
ITERS = 5


def time_sampler(sampler, model, noise_dim: int, latents: torch.Tensor,
                 noise: torch.Tensor, nfe: int, device: torch.device) -> dict:
    wall = time_calls(
        lambda: sampler(model, noise_dim, latents, n_steps=nfe, noise=noise),
        device, ITERS)
    batch = latents.shape[0]
    return {"batch": batch, "ms_per_batch": round(wall * 1e3, 2),
            "ms_per_sample": round(wall / batch * 1e3, 3)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--noise-dim", type=int, default=784)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--nfe", type=int, nargs="+",
                        default=[1, 10, 50, 250])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)

    model = ConditionalFlow(args.noise_dim, 128, 8, 256,
                            compute_dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    latents = torch.ones((args.batch, 256), device=device)
    noise = torch.randn((args.batch, args.noise_dim),
                        generator=torch.Generator(device).manual_seed(1),
                        device=device)
    return sweep(
        ({"nfe": nfe, "sampler": name},
         lambda nfe=nfe, name=name, sampler=sampler: {
             "nfe": nfe, "sampler": name, **time_sampler(
                 sampler, model, args.noise_dim, latents, noise, nfe,
                 device)})
        for nfe in args.nfe for name, sampler in SAMPLERS.items())


if __name__ == "__main__":
    raise SystemExit(main())
