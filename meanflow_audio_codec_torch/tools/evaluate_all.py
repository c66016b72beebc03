"""Batch evaluation runner: glob configs -> each run's latest checkpoint ->
held-out real data -> ComprehensiveEvaluator -> one CSV row per (config,
NFE).

Counterpart of ``meanflow_audio_codec_tpu/tools/evaluate_all.py``, with its
flags, result files and CSV rows; ``--device`` (default ``cuda``) picks
where the models run. ``--quantized`` serves each convnet run through the
W8A8 int8 decoder (``ops/quant.py``) from the same checkpoint.

    python -m meanflow_audio_codec_torch.tools.evaluate_all \\
        --configs configs --nfe 1 10 --csv metrics.csv
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from meanflow_audio_codec_torch.codec import with_quantized_decoder
from meanflow_audio_codec_torch.configs import CodecConfig, load_config
from meanflow_audio_codec_torch.evaluators.comprehensive_evaluator import (
    DEFAULT_NFE_SWEEP,
    ComprehensiveEvaluator,
)
from meanflow_audio_codec_torch.training.checkpoints import (
    find_latest_checkpoint,
)
from meanflow_audio_codec_torch.training.logging import append_metrics_csv

#: metric columns of the CSV rows, where an entry has them
CSV_METRICS = ("mse", "psnr_db", "ssim", "fid_pixel", "kid_pixel",
               "spectral_distance", "si_snr_db", "stoi", "pesq")


def find_checkpoint_for(config: CodecConfig) -> Path | None:
    return find_latest_checkpoint(Path(config.workdir) / "checkpoints")


def load_real_data(config: CodecConfig, num_samples: int,
                   synthetic_family: str | None = None) -> np.ndarray:
    """Held-out raw data for conditioning and the quality metrics: audio
    from an existing ``data_dir`` or, else, from the synthetic family named
    by ``synthetic_family`` (else the config's), both at ``seed+1``; for
    MNIST the test split."""
    if config.dataset == "audio":
        from meanflow_audio_codec_torch.data.audio import (
            build_audio_pipeline,
            synthetic_pipeline_for_family,
        )
        tok_cfg = config.tokenization_config
        frame_size = tok_cfg.get("frame_size", 65536)
        if config.data_dir and Path(config.data_dir).exists():
            pipeline = build_audio_pipeline(
                config.data_dir, seed=config.seed + 1,
                frame_size=frame_size, batch_size=num_samples)
        else:
            family = synthetic_family or tok_cfg.get("synthetic_family")
            pipeline = synthetic_pipeline_for_family(
                family, seed=config.seed + 1, frame_size=frame_size,
                batch_size=num_samples)
        return next(iter(pipeline))
    from meanflow_audio_codec_torch.data.mnist import load_mnist
    _, test_iter = load_mnist(batch_size=num_samples, seed=config.seed)
    return next(test_iter)


def evaluate_config(config_path: Path, nfe_list: list[int],
                    num_samples: int, csv_path: Path | None,
                    synthetic_family: str | None = None,
                    results_name: str = "evaluation_results.json",
                    quantized: bool = False,
                    latent_bits: int | None = None,
                    latent_step: float | None = None,
                    timing_runs: int = 5,
                    device: str = "cuda") -> dict | None:
    """Evaluate one config's run and write ``<workdir>/<results_name>`` (and
    the CSV rows); None, with a printed "skip", when it has no checkpoint."""
    config = load_config(config_path)
    if quantized:
        # the same checkpoint through the int8 decoder: the parameters are
        # unchanged, so the load is too
        config = with_quantized_decoder(config)
    checkpoint = find_checkpoint_for(config)
    if checkpoint is None:
        print(f"skip {config_path.name}: no checkpoint under "
              f"{config.workdir}")
        return None
    data = load_real_data(config, num_samples,
                          synthetic_family=synthetic_family)
    evaluator = ComprehensiveEvaluator(checkpoint, config, nfe_list=nfe_list,
                                       num_samples=num_samples,
                                       latent_bits=latent_bits,
                                       latent_step=latent_step,
                                       timing_runs=timing_runs, device=device)
    results = evaluator.evaluate(data)
    evaluator.save_results(results, Path(config.workdir) / results_name)
    if csv_path is not None:
        for nfe_key, entry in results["nfe_sweep"].items():
            row = {
                "config": config_path.stem,
                "method": config.method,
                "architecture": config.architecture,
                "dataset": config.dataset,
                "tokenization": config.tokenization_strategy,
                "nfe": nfe_key,
                "param_count": results["param_count"],
                "inference_mean_sec": entry["inference"]["mean_sec"],
            }
            row.update({m: entry[m] for m in CSV_METRICS if m in entry})
            append_metrics_csv(csv_path, row)
    mse = {k: round(v["mse"], 5) for k, v in results["nfe_sweep"].items()}
    print(f"evaluated {config_path.name}: {json.dumps(mse)}")
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate all trained configs")
    parser.add_argument("--configs", type=Path, default=Path("configs"),
                        help="directory of config JSONs (globbed *.json)")
    parser.add_argument("--nfe", type=int, nargs="+",
                        default=list(DEFAULT_NFE_SWEEP))
    parser.add_argument("--num-samples", type=int, default=64)
    parser.add_argument("--csv", type=Path, default=Path("metrics.csv"))
    parser.add_argument("--synthetic-family", type=str, default=None,
                        help="override the synthetic eval generator family "
                             "(e.g. 'rich') for cross-family generalization")
    parser.add_argument("--results-name", type=str,
                        default="evaluation_results.json",
                        help="per-workdir results filename (use e.g. "
                             "evaluation_results_rich.json so a cross-family "
                             "pass never clobbers the in-family results)")
    parser.add_argument("--quantized", action="store_true",
                        help="serve checkpoints through the int8 W8A8 "
                             "decode path (convnet family only)")
    parser.add_argument("--latent-bits", type=int, default=None,
                        choices=(4, 8, 16),
                        help="decode from the scalar-quantized latent "
                             "bitstream (ops/latent_quant.py) instead of "
                             "float latents — the stored-format quality")
    parser.add_argument("--latent-step", type=float, default=None,
                        help="decode from the rate-aware ECSQ bitstream "
                             "(MACB v2) at this step fraction of the "
                             "per-frame residual std (takes precedence over "
                             "--latent-bits)")
    parser.add_argument("--timing-runs", type=int, default=5,
                        help="repetitions for the inference-latency "
                             "benchmark; 0 skips timing entirely")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    config_paths = sorted(args.configs.glob("*.json"))
    if not config_paths:
        print(f"no configs under {args.configs}")
        return 1
    evaluated = 0
    for path in config_paths:
        try:
            if evaluate_config(path, args.nfe, args.num_samples, args.csv,
                               synthetic_family=args.synthetic_family,
                               results_name=args.results_name,
                               quantized=args.quantized,
                               latent_bits=args.latent_bits,
                               latent_step=args.latent_step,
                               timing_runs=args.timing_runs,
                               device=args.device) is not None:
                evaluated += 1
        except Exception as exc:
            print(f"FAILED {path.name}: {exc}")
    print(f"Evaluated {evaluated}/{len(config_paths)} configs -> {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
