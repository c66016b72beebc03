"""iMF ConvNet train-step MFU sweep over stage geometries.

Counterpart of ``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_conv_mfu.py``,
with its ``CONFIGS``: lane-aligned channels, power-of-two grids, factorised
lifts, large batches with stage remat (``dots_saveable`` recomputes only
the elementwise segments) and the ``fused_stage`` rows, whose LN + FiLM,
LN and GELU + GRN run as the three stage kernels of ``csrc/stage.cu``.
Each row times the iMF step through ``training/train_step.make_multi_step``
(``scan_k`` steps a call, one warm-up call, then ``iters`` calls ended by
``torch.cuda.synchronize``) and reports steps/s and MFU.

The MFU numerator is the JAX script's: the FLOPs of one step of the
non-remat, non-fused clone of the model (recompute earns no credit, and
the FLOP counter cannot see inside a kernel's ctypes call any more than
XLA's cost analysis inside a Pallas call), counted by
``training/profiling.estimate_step_flops`` on the meta device (shapes
only, no memory). The peak is the card's dense bf16 rate
(``training/profiling.peak_flops``); on the CPU ``mfu`` is None. One JSON
row per config::

    {"config", <geometry>, "params_m", "batch", "steps_per_sec",
     "step_gflop", "mfu", "tflops"}

A config that raises (an
out-of-memory, say) prints ``{"config", "error"}`` and the script returns 1.

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_conv_mfu \
        --configs ch512_s8_lift64_bn1024_b2048_dots
"""

from __future__ import annotations

import argparse

import torch

from meanflow_audio_codec_torch.evaluators.performance import force_completion
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    Clock,
    start,
    sweep,
)
from meanflow_audio_codec_torch.training.objectives import (
    ImprovedMeanFlowObjective,
)
from meanflow_audio_codec_torch.training.profiling import (
    estimate_step_flops,
    peak_flops,
)
from meanflow_audio_codec_torch.training.simple_trainer import (
    create_train_state,
)
from meanflow_audio_codec_torch.training.train_step import make_multi_step


def build_model(noise_dim: int, num_blocks: int, remat: bool = False,
                device: torch.device | str = "cpu",
                **model_kwargs) -> ConditionalConvFlow:
    """The benchmark's flow in bf16 compute, its parameters uninitialised
    (on the meta device: shapes only)."""
    with torch.device(device):
        return ConditionalConvFlow(noise_dimension=noise_dim,
                                   condition_dimension=256,
                                   num_blocks=num_blocks,
                                   latent_dimension=256,
                                   compute_dtype=torch.bfloat16, remat=remat,
                                   **model_kwargs)


def model_flops(objective, noise_dim: int, batch: int, num_blocks: int,
                **model_kwargs) -> float | None:
    """FLOPs of one step (loss and gradients; the optimiser adds no product)
    of the non-remat, non-fused clone, counted on the meta device."""
    kwargs = {**model_kwargs, "fused_stage": False, "remat_policy": None}
    model = build_model(noise_dim, num_blocks, device="meta", **kwargs)
    x = torch.empty((batch, noise_dim), device="meta")

    def probe():
        loss, _ = objective.loss(model, x, **objective.draw(model, x))
        torch.autograd.grad(loss, list(model.parameters()))

    return estimate_step_flops(probe)


def bench_config(name: str, *, noise_dim: int = 1152, batch: int = 512,
                 scan_k: int = 8, iters: int = 4, remat: bool = False,
                 device: str | torch.device = "cuda", **model_kwargs) -> dict:
    device = torch.device(device)
    num_blocks = model_kwargs.pop("num_blocks", 8)
    objective = ImprovedMeanFlowObjective()
    flops = model_flops(objective, noise_dim, batch, num_blocks,
                        **model_kwargs)
    # optax.adamw(1e-4) over weights drawn on the device from a generator
    # seeded 0
    state = create_train_state(
        build_model(noise_dim, num_blocks, remat=remat, device=device,
                    **model_kwargs),
        torch.Generator(device).manual_seed(0), batch, 1e-4, device=device)
    step = make_multi_step(objective, scan_k)
    batches = torch.randn((scan_k, batch, noise_dim),
                          generator=torch.Generator(device).manual_seed(3),
                          device=device)
    state, metrics = step(state, batches,
                          generator=torch.Generator(device).manual_seed(4))
    force_completion(metrics["loss"])
    gen = torch.Generator(device).manual_seed(5)
    with Clock(device) as clock:
        for _ in range(iters):
            state, metrics = step(state, batches, generator=gen)
    if not torch.isfinite(metrics["loss"]).all():
        raise FloatingPointError(f"{name}: non-finite loss")
    wall = clock.wall / (iters * scan_k)
    n_params = sum(p.numel() for p in state.params)
    row = {"config": name, **model_kwargs,
           "params_m": round(n_params / 1e6, 1), "batch": batch,
           "steps_per_sec": round(1.0 / wall, 2)}
    if flops:
        peak = peak_flops(device)
        row["step_gflop"] = round(flops / 1e9, 1)
        row["mfu"] = round(flops / wall / peak, 4) if peak else None
        row["tflops"] = round(flops / wall / 1e12, 1)
    return row


#: run knobs (batch/scan_k/remat) ride along with the model kwargs.
CONFIGS = {
    "r1_baseline": dict(channels=64, bottleneck_dim=512),
    "ch128_s32_lift16": dict(channels=128, bottleneck_dim=512, spatial=32,
                             lift_channels=16),
    "ch128_s16_dense": dict(channels=128, bottleneck_dim=512, spatial=16),
    "ch256_s16_lift32": dict(channels=256, bottleneck_dim=512, spatial=16,
                             lift_channels=32),
    # fold the step batch up (larger M per product), remat stages to fit
    "ch128_s32_lift16_b2048": dict(channels=128, bottleneck_dim=512,
                                   spatial=32, lift_channels=16,
                                   batch=2048, scan_k=2, remat=True),
    "ch256_s16_lift32_b2048": dict(channels=256, bottleneck_dim=512,
                                   spatial=16, lift_channels=32,
                                   batch=2048, scan_k=2, remat=True),
    "ch256_s16_lift32_b4096": dict(channels=256, bottleneck_dim=512,
                                   spatial=16, lift_channels=32,
                                   batch=4096, scan_k=1, remat=True),
    "ch128_s16_dense_b4096": dict(channels=128, bottleneck_dim=512,
                                  spatial=16, batch=4096, scan_k=1,
                                  remat=True),
    # no-remat large-batch s16 variants (small grids may fit raw)
    "ch256_s16_lift32_b1024": dict(channels=256, bottleneck_dim=512,
                                   spatial=16, lift_channels=32,
                                   batch=1024, scan_k=4),
    "ch128_s16_dense_b2048": dict(channels=128, bottleneck_dim=512,
                                  spatial=16, batch=2048, scan_k=2),
    # dots-saveable remat: recompute only elementwise, keep the products
    "ch256_s16_lift32_b2048_dots": dict(channels=256, bottleneck_dim=512,
                                        spatial=16, lift_channels=32,
                                        batch=2048, scan_k=2, remat=True,
                                        remat_policy="dots_saveable"),
    "ch128_s32_lift16_b2048_dots": dict(channels=128, bottleneck_dim=512,
                                        spatial=32, lift_channels=16,
                                        batch=2048, scan_k=2, remat=True,
                                        remat_policy="dots_saveable"),
    # wider channels / smaller grid: conv + 1x1 contractions at K=N>=512
    "ch512_s8_lift64_b2048_dots": dict(channels=512, bottleneck_dim=512,
                                       spatial=8, lift_channels=64,
                                       batch=2048, scan_k=2, remat=True,
                                       remat_policy="dots_saveable"),
    "ch256_s16_lift32_b4096_dots": dict(channels=256, bottleneck_dim=512,
                                        spatial=16, lift_channels=32,
                                        batch=4096, scan_k=1, remat=True,
                                        remat_policy="dots_saveable"),
    # wider bottleneck: bigger-K lift matmuls
    "ch256_s16_lift32_bn1024_b2048_dots": dict(
        channels=256, bottleneck_dim=1024, spatial=16, lift_channels=32,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable"),
    "ch384_s16_lift48_b2048_dots": dict(
        channels=384, bottleneck_dim=512, spatial=16, lift_channels=48,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable"),
    "ch256_s16_lift32_bn2048_b2048_dots": dict(
        channels=256, bottleneck_dim=2048, spatial=16, lift_channels=32,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable"),
    "ch256_s16_lift64_bn1024_b2048_dots": dict(
        channels=256, bottleneck_dim=1024, spatial=16, lift_channels=64,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable"),
    "ch256_s16_lift32_bn1024_b3072_dots": dict(
        channels=256, bottleneck_dim=1024, spatial=16, lift_channels=32,
        batch=3072, scan_k=1, remat=True, remat_policy="dots_saveable"),
    # scale-ups of the s8/ch512 row: same 8x8 grid, more capacity via
    # bottleneck width / lift / depth / channels
    "ch512_s8_lift64_bn1024_b2048_dots": dict(
        channels=512, bottleneck_dim=1024, spatial=8, lift_channels=64,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable"),
    "ch512_s8_lift128_bn1024_b2048_dots": dict(
        channels=512, bottleneck_dim=1024, spatial=8, lift_channels=128,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable"),
    "ch512_s8_lift64_nb16_b2048_dots": dict(
        channels=512, bottleneck_dim=512, spatial=8, lift_channels=64,
        num_blocks=16, batch=2048, scan_k=2, remat=True,
        remat_policy="dots_saveable"),
    "ch1024_s8_lift64_b2048_dots": dict(
        channels=1024, bottleneck_dim=512, spatial=8, lift_channels=64,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable"),
    # the ch1024 s8 row deeper / wider still
    "ch1024_s8_lift64_nb16_b2048_dots": dict(
        channels=1024, bottleneck_dim=512, spatial=8, lift_channels=64,
        num_blocks=16, batch=2048, scan_k=1, remat=True,
        remat_policy="dots_saveable"),
    "ch2048_s8_lift128_b1024_dots": dict(
        channels=2048, bottleneck_dim=512, spatial=8, lift_channels=128,
        batch=1024, scan_k=2, remat=True, remat_policy="dots_saveable"),
    "ch1024_s8_lift128_bn1024_b2048_dots": dict(
        channels=1024, bottleneck_dim=1024, spatial=8, lift_channels=128,
        batch=2048, scan_k=1, remat=True, remat_policy="dots_saveable"),
    # remat off at the bench geometry: the recompute tax the MFU numerator
    # does not credit, at no-remat batches
    "ch1024_s8_lift64_b1024_noremat": dict(
        channels=1024, bottleneck_dim=512, spatial=8, lift_channels=64,
        batch=1024, scan_k=2),
    "ch1024_s8_lift64_b512_noremat": dict(
        channels=1024, bottleneck_dim=512, spatial=8, lift_channels=64,
        batch=512, scan_k=4),
    "ch1024_s8_lift64_b2048_noremat": dict(
        channels=1024, bottleneck_dim=512, spatial=8, lift_channels=64,
        batch=2048, scan_k=2),
    # the fused stage kernels (csrc/stage.cu) on the same geometries: one
    # pass for each norm/FiLM/GELU/GRN segment
    "ch1024_s8_lift64_b2048_dots_fused": dict(
        channels=1024, bottleneck_dim=512, spatial=8, lift_channels=64,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable",
        fused_stage=True),
    "ch512_s8_lift64_bn1024_b2048_dots_fused": dict(
        channels=512, bottleneck_dim=1024, spatial=8, lift_channels=64,
        batch=2048, scan_k=2, remat=True, remat_policy="dots_saveable",
        fused_stage=True),
    "ch1024_s8_lift64_nb16_b2048_dots_fused": dict(
        channels=1024, bottleneck_dim=512, spatial=8, lift_channels=64,
        num_blocks=16, batch=2048, scan_k=1, remat=True,
        remat_policy="dots_saveable", fused_stage=True),
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS),
                        choices=list(CONFIGS))
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--scan-k", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)

    def run(name: str) -> dict:
        kwargs = dict(CONFIGS[name])
        batch = kwargs.pop("batch", args.batch)
        scan_k = kwargs.pop("scan_k", args.scan_k)
        row = bench_config(name, batch=batch, scan_k=scan_k, device=device,
                           **kwargs)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return row

    return sweep(({"config": name}, lambda name=name: run(name))
                 for name in args.configs)


if __name__ == "__main__":
    raise SystemExit(main())
