"""Streaming-serving benchmark: per-chunk latency and RTF of the duplex path.

Counterpart of
``meanflow_audio_codec_tpu/tools/benchmarks/benchmark_streaming.py``, with
its ``GEOMETRIES``: a fixed-size chunk of 48 kHz stereo pushed through
``streaming.StreamingCodec`` (encode -> 1-NFE decode -> overlap-add emit),
each push ended by ``torch.cuda.synchronize``: the per-chunk wall latency a
realtime caller sees, beside the 2W - hop algorithmic lookahead. On the
card every push runs the MDCT kernel (when its samples complete a frame)
and the IMDCT kernel.

Per (geometry, chunk length): the steady-state push wall (median, after 3
warm-up pushes), its 90th percentile, the streaming RTF (chunk seconds /
push wall) and the realtime load wall/chunk (below 1 keeps up with a
live stream). One JSON row per combination::

    {"config", "params_m", "chunk_ms", "push_wall_ms", "p90_wall_ms",
     "streaming_rtf", "realtime_load", "latency_ms"}

    python -m meanflow_audio_codec_torch.tools.benchmarks.benchmark_streaming \
        --configs light_ch256 --chunk-seconds 0.1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.evaluators.performance import force_completion
from meanflow_audio_codec_torch.configs import CodecConfig, config_from_dict
from meanflow_audio_codec_torch.models.conv_flow import ConditionalConvFlow
from meanflow_audio_codec_torch.models.factories import init_weights
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    Clock,
    start,
    sweep,
)

SAMPLE_RATE = 48000
WINDOW = 576

GEOMETRIES = {
    # the quality/RTF frontier endpoints (documentation/performance.md):
    # the v2 quality geometry and the light ch256 profile
    "quality_ch512_bn1024": dict(num_blocks=8, channels=512,
                                 bottleneck_dim=1024, spatial=8,
                                 lift_channels=64),
    "light_ch256": dict(num_blocks=8, channels=256, bottleneck_dim=512,
                        spatial=8, lift_channels=32),
}


def codec_config(noise_dim: int, latent_dim: int, num_blocks: int
                 ) -> CodecConfig:
    """The JAX script's config: audio through the MDCT (W 576,
    normalized), iMF, 1-step sampling."""
    return config_from_dict({
        "base": {"batch_size": 1, "n_steps": 1, "base_lr": 1e-4,
                 "weight_decay": 0.0, "seed": 0},
        "model": {"noise_dimension": noise_dim, "condition_dimension": 256,
                  "latent_dimension": latent_dim, "num_blocks": num_blocks},
        "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                    "tokenization_config": {"window_size": WINDOW,
                                            "normalize": True}},
        "method": {"method": "improved_mean_flow",
                   "use_improved_mean_flow": True},
        "training": {"sample_every": 1000, "sample_seed": 0,
                     "sample_steps": 1},
    })


def _build_codec(name: str, device: torch.device | str = "cuda",
                 **model_kwargs) -> tuple[AudioCodec, int]:
    """An AudioCodec over random weights drawn on ``device`` from a
    generator seeded 0 (timing needs the geometry, not a trained
    checkpoint), bf16 compute, and its parameter count."""
    del name
    noise_dim = WINDOW * 2
    latent_dim = 256
    with torch.device(device):
        model = ConditionalConvFlow(noise_dimension=noise_dim,
                                    condition_dimension=256,
                                    latent_dimension=latent_dim,
                                    compute_dtype=torch.bfloat16,
                                    **model_kwargs)
    init_weights(model, torch.Generator(device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    config = codec_config(noise_dim, latent_dim,
                          model_kwargs.get("num_blocks", 8))
    return AudioCodec(model, None, config, device=device), n_params


def bench_streaming(name: str, chunk_seconds: float, *, pushes: int = 32,
                    device: str | torch.device = "cuda",
                    **model_kwargs) -> dict:
    device = torch.device(device)
    codec, n_params = _build_codec(name, device, **model_kwargs)
    duplex = codec.streaming(seed=0)
    hop = duplex.encoder.hop
    chunk = max(hop, int(SAMPLE_RATE * chunk_seconds) // hop * hop)
    rng = np.random.default_rng(0)

    def make() -> torch.Tensor:
        audio = rng.standard_normal((1, chunk, 2)) * 0.3
        return torch.from_numpy(audio.astype(np.float32)).to(device)

    # reach steady state (the first pushes emit fewer frames, possibly
    # none while the encoder fills its 2W lookahead)
    for _ in range(3):
        force_completion(duplex.push(make()))
    walls = []
    for _ in range(pushes):
        x = make()
        with Clock(device) as clock:
            duplex.push(x)
        walls.append(clock.wall)
    wall = float(np.median(walls))
    chunk_s = chunk / SAMPLE_RATE
    return {"config": name, "params_m": round(n_params / 1e6, 1),
            "chunk_ms": round(chunk_s * 1e3, 1),
            "push_wall_ms": round(wall * 1e3, 2),
            "p90_wall_ms": round(float(np.quantile(walls, 0.9)) * 1e3, 2),
            "streaming_rtf": round(chunk_s / wall, 1),
            "realtime_load": round(wall / chunk_s, 4),
            "latency_ms": round(duplex.latency_samples / SAMPLE_RATE * 1e3,
                                1)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--configs", nargs="+", default=list(GEOMETRIES),
                        choices=list(GEOMETRIES))
    parser.add_argument("--chunk-seconds", nargs="+", type=float,
                        default=[0.02, 0.1, 1.0])
    parser.add_argument("--pushes", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    return sweep(
        ({"config": name, "chunk_seconds": chunk_s},
         lambda name=name, chunk_s=chunk_s: bench_streaming(
             name, chunk_s, pushes=args.pushes, device=device,
             **GEOMETRIES[name]))
        for name in args.configs for chunk_s in args.chunk_seconds)


if __name__ == "__main__":
    raise SystemExit(main())
