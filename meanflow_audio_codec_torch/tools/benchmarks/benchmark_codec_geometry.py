"""Codec-path RTF sweep over decoder geometries.

Counterpart of
``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_codec_geometry.py``,
with its ``CONFIGS``: the *inference* path of one codec call, MDCT tokenize
-> encode -> one dual-time decoder call at (t=1, h=1) -> IMDCT, over
16 clips of 10 s of 48 kHz stereo (W 576, normalized), for candidate
ConvNeXt geometries in bf16 with seeded random weights. On the card each
call launches one MDCT and one IMDCT kernel (``ops/tokenize``);
``--quantized`` runs the decoder's products in dynamic W8A8 int8
(``ops/quant.py``, 72 ``torch._int_mm`` products a call at the lifted
8-block geometries).

Each call is timed as the JAX script times it: one warm-up call, then the
best of 3 groups of 10 calls, each group ended by
``torch.cuda.synchronize``. One JSON row per geometry::

    {"config", <geometry>, "quantized", "params_m", "wall_ms", "rtf"}

A geometry that raises prints ``{"config", "error"}`` and the script
returns 1.

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_codec_geometry \
        --configs ch256_s8_lift32 [--quantized]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
from meanflow_audio_codec_torch.models.factories import init_weights
from meanflow_audio_codec_torch.ops.mdct import MDCTConfig
from meanflow_audio_codec_torch.ops.tokenize import MDCTTokenization
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    start,
    sweep,
    time_calls,
)

SAMPLE_RATE = 48000
WINDOW = 576
CLIP_SECONDS = 10.0
ITERS, GROUPS = 10, 3


def build_model(device: torch.device, quantized: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16,
                **model_kwargs) -> ConditionalConvFlow:
    """The codec's flow at one geometry in inference mode, built on
    ``device`` with weights drawn there from a generator seeded 0."""
    with torch.device(device):
        model = ConditionalConvFlow(noise_dimension=WINDOW * 2,
                                    condition_dimension=256,
                                    latent_dimension=256, quantized=quantized,
                                    compute_dtype=compute_dtype,
                                    **model_kwargs)
    init_weights(model, torch.Generator(device).manual_seed(0))
    return model.eval()


def tokenizer() -> MDCTTokenization:
    return MDCTTokenization(config=MDCTConfig(window_size=WINDOW,
                                              normalize=True))


@torch.no_grad()
def codec(model: ConditionalConvFlow, tok: MDCTTokenization,
          audio: torch.Tensor) -> torch.Tensor:
    """``[B, T, 2]`` audio -> tokens -> latents -> one decoder call over the
    full interval (1 -> 0) -> audio."""
    tokens = tok.tokenize(audio)
    b, nf, width = tokens.shape
    frames = tokens.reshape(b * nf, width)
    latents = model.encode(frames)
    t = torch.ones((frames.shape[0], 1), dtype=frames.dtype,
                   device=frames.device)
    pair = torch.cat([t, t], dim=-1)
    u = model(frames, pair, latents)
    decoded = (frames - u.to(frames.dtype)).reshape(b, nf, width)
    return tok.detokenize(decoded)


def seeded_audio(batch_clips: int, clip_seconds: float,
                 device: torch.device) -> torch.Tensor:
    """Seeded noise clips ``[B, T, 2]`` at 0.3 RMS, float32."""
    rng = np.random.default_rng(0)
    samples = int(SAMPLE_RATE * clip_seconds)
    audio = (rng.standard_normal((batch_clips, samples, 2)) * 0.3).astype(
        np.float32)
    return torch.from_numpy(audio).to(device)


def bench_geometry(name: str, *, batch_clips: int = 16,
                   iters: int | None = None, groups: int | None = None,
                   clip_seconds: float = CLIP_SECONDS,
                   quantized: bool = False,
                   device: str | torch.device = "cuda",
                   **model_kwargs) -> dict:
    """One codec geometry's row: ``groups`` timed groups of ``iters`` calls
    (the module's ``GROUPS`` and ``ITERS`` when unset)."""
    iters = ITERS if iters is None else iters
    groups = GROUPS if groups is None else groups
    device = torch.device(device)
    tok = tokenizer()
    model = build_model(device, quantized=quantized, **model_kwargs)
    audio = seeded_audio(batch_clips, clip_seconds, device)
    wall = time_calls(lambda: codec(model, tok, audio), device, iters,
                      groups)
    n_params = sum(p.numel() for p in model.parameters())
    audio_seconds = batch_clips * clip_seconds
    return {"config": name, **model_kwargs, "quantized": quantized,
            "params_m": round(n_params / 1e6, 1),
            "wall_ms": round(wall * 1e3, 1),
            "rtf": round(audio_seconds / wall, 1)}


CONFIGS = {
    # bench.py round-1/2 flagship: 33x33-class dense grid at ch32
    "r1_flagship_ch32": dict(num_blocks=8, channels=32, bottleneck_dim=256),
    # the train-side winners, at inference scale
    "ch256_s8_lift32": dict(num_blocks=8, channels=256, bottleneck_dim=512,
                            spatial=8, lift_channels=32),
    # quality-run v1 geometry (outputs/imf_audio_quality)
    "ch128_s16_lift16": dict(num_blocks=8, channels=128, bottleneck_dim=512,
                             spatial=16, lift_channels=16),
    "ch512_s8_lift64": dict(num_blocks=8, channels=512, bottleneck_dim=512,
                            spatial=8, lift_channels=64),
    "ch512_s8_lift64_bn1024": dict(num_blocks=8, channels=512,
                                   bottleneck_dim=1024, spatial=8,
                                   lift_channels=64),
    "ch1024_s8_lift64": dict(num_blocks=8, channels=1024, bottleneck_dim=512,
                             spatial=8, lift_channels=64),
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS),
                        choices=list(CONFIGS))
    parser.add_argument("--batch-clips", type=int, default=16)
    parser.add_argument("--clip-seconds", type=float, default=CLIP_SECONDS)
    parser.add_argument("--quantized", action="store_true",
                        help="serve the decode matmuls/convs in dynamic "
                             "W8A8 int8 (ops/quant.py)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    return sweep(({"config": name}, lambda name=name: bench_geometry(
        name, batch_clips=args.batch_clips, clip_seconds=args.clip_seconds,
        quantized=args.quantized, device=device, **CONFIGS[name]))
        for name in args.configs)


if __name__ == "__main__":
    raise SystemExit(main())
