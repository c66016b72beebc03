"""Experiment-matrix config generator.

Counterpart of ``meanflow_audio_codec_torch/tools/generate_configs.py``, with
its files byte for byte: the 4 methods x 3 architectures x 2 tokenizations
x 2 datasets base matrix (48 configs, named
``method={m}--architecture={a}--dataset={d}--tokenization={t}.json``) plus
the ablation families: gamma sweep, data-proportion (flow-ratio) sweep,
learning-rate sweep, small/medium/large architecture scaling, and method
ablations (stop-gradient off, loss-weighting variants).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from pathlib import Path

from meanflow_audio_codec_torch.configs import (
    CodecConfig,
    create_audio_config,
    create_mnist_config,
    merge_configs,
    save_config_to_json,
)

METHODS = ["autoencoder", "flow_matching", "mean_flow", "improved_mean_flow"]
ARCHITECTURES = ["mlp", "mlp_mixer", "convnet"]
TOKENIZATIONS = ["mdct", "reshape"]
DATASETS = ["mnist", "audio"]

#: architecture scaling families (reference generate_configs.py:217-278)
SIZES = {
    "small": {"num_blocks": 4, "latent_dimension": 256},
    "medium": {"num_blocks": 8, "latent_dimension": 512},
    "large": {"num_blocks": 16, "latent_dimension": 1024},
}
GAMMA_SWEEP = [0.25, 0.5, 1.0, 1.5, 2.0]
DATA_PROPORTION_SWEEP = [0.25, 0.5, 0.75, 1.0]
LR_SWEEP = [3e-5, 1e-4, 3e-4, 1e-3]


def base_config(method: str, architecture: str, dataset: str,
                tokenization: str, workdir_root: str) -> CodecConfig:
    factory = create_audio_config if dataset == "audio" else create_mnist_config
    name = (f"method={method}--architecture={architecture}"
            f"--dataset={dataset}--tokenization={tokenization}")
    overrides = {
        "model": {"architecture": architecture},
        "dataset": {"tokenization_strategy": tokenization},
        "method": {
            "method": method,
            "use_improved_mean_flow": method == "improved_mean_flow",
        },
        "training": {"workdir": f"{workdir_root}/{name}"},
    }
    return merge_configs(factory(), overrides)


def config_name(config: CodecConfig) -> str:
    return (f"method={config.method}--architecture={config.architecture}"
            f"--dataset={config.dataset}"
            f"--tokenization={config.tokenization_strategy}")


def generate_matrix(out_dir: Path, workdir_root: str = "./outputs"
                    ) -> list[Path]:
    """The 48-config base matrix."""
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for method, arch, dataset, tok in itertools.product(
            METHODS, ARCHITECTURES, DATASETS, TOKENIZATIONS):
        config = base_config(method, arch, dataset, tok, workdir_root)
        path = out_dir / f"{config_name(config)}.json"
        save_config_to_json(config, path)
        written.append(path)
    return written


def generate_ablations(out_dir: Path, workdir_root: str = "./outputs"
                       ) -> list[Path]:
    """Ablation families around the flagship iMF configs."""
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []

    def emit(config: CodecConfig, name: str) -> None:
        config = dataclasses.replace(
            config, workdir=f"{workdir_root}/ablations/{name}")
        path = out_dir / f"{name}.json"
        save_config_to_json(config, path)
        written.append(path)

    flagship = lambda: base_config("mean_flow", "mlp", "mnist", "reshape",
                                   workdir_root)
    for gamma in GAMMA_SWEEP:
        config = merge_configs(flagship(), {"method": {"gamma": gamma}})
        emit(config, f"ablation--gamma={gamma}")
    for proportion in DATA_PROPORTION_SWEEP:
        config = merge_configs(flagship(), {
            "method": {"time_sampling": "mean_flow",
                       "time_sampling_data_proportion": proportion}})
        emit(config, f"ablation--data_proportion={proportion}")
    for lr in LR_SWEEP:
        config = merge_configs(flagship(), {"base": {"base_lr": lr}})
        emit(config, f"ablation--lr={lr}")
    for size, model_kwargs in SIZES.items():
        config = merge_configs(flagship(), {"model": model_kwargs})
        emit(config, f"ablation--size={size}")
    # method ablations (reference generate_configs.py:281-332)
    imf = base_config("improved_mean_flow", "mlp", "mnist", "reshape",
                      workdir_root)
    emit(merge_configs(imf, {"method": {"use_stop_gradient": False}}),
         "ablation--no_stop_gradient")
    for weighting in ("uniform", "time_dependent", "learned"):
        emit(merge_configs(imf, {"method": {"loss_weighting": weighting}}),
             f"ablation--loss_weighting={weighting}")
    emit(merge_configs(imf, {"method": {"use_weighted_loss": False}}),
         "ablation--unweighted_loss")
    # full-interval corner supervision (TPU framework extension: the slice
    # of each batch trained at the exact (t=1, r=0) 1-NFE decode query)
    for full in (0.0, 0.125, 0.25):
        emit(merge_configs(imf, {
            "method": {"time_sampling": "mean_flow",
                       "time_sampling_full_proportion": full}}),
             f"ablation--full_interval={full}")
    return written


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Generate experiment configs")
    parser.add_argument("--out-dir", type=Path, default=Path("configs"))
    parser.add_argument("--workdir-root", type=str, default="./outputs")
    parser.add_argument("--no-ablations", action="store_true")
    args = parser.parse_args(argv)
    written = generate_matrix(args.out_dir, args.workdir_root)
    print(f"Wrote {len(written)} matrix configs to {args.out_dir}")
    if not args.no_ablations:
        ablations = generate_ablations(args.out_dir / "ablations",
                                       args.workdir_root)
        print(f"Wrote {len(ablations)} ablation configs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
