"""PyTorch port: the config layer (``configs.py``) and the flag-driven CLI
(``train.py``) against the JAX package's ``configs/config.py`` and the
repository's root ``train.py``.

What is compared: the values each side rejects (``ValueError``, or
``TypeError`` for a field a section does not have), v1 migration, the v2
dict of every config file, flat and hierarchical merges, diffs, the two
factories, the bytes ``save_config_to_json`` writes, and for argv lists of
the root CLI (flag-driven runs of each family and dataset, and
``--config`` with overrides) the config each CLI builds: its v2 dict, equal
field for field. No tolerance: every comparison is exact.
"""

import copy
import importlib.util
import json
from pathlib import Path

import pytest

from meanflow_audio_codec_tpu import configs as jconfigs
from meanflow_audio_codec_torch import configs
from meanflow_audio_codec_torch import train as cli

REPO = Path(__file__).resolve().parents[1]
CONFIG_FILES = sorted((REPO / "configs").rglob("*.json"))


def _root_cli():
    spec = importlib.util.spec_from_file_location("root_train",
                                                  REPO / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ROOT = _root_cli()

VALID = {
    "config_version": "2.0",
    "base": {"batch_size": 32, "n_steps": 100, "base_lr": 1e-4,
             "weight_decay": 1e-4, "seed": 0},
    "model": {"noise_dimension": 784, "condition_dimension": 64,
              "latent_dimension": 32, "num_blocks": 2},
    "dataset": {"dataset": "mnist", "tokenization_strategy": "reshape"},
    "method": {},
    "training": {"sample_every": 10, "sample_seed": 0, "sample_steps": 5,
                 "workdir": "/tmp/test_run"},
}


def _with(section, **values):
    data = copy.deepcopy(VALID)
    data[section].update(values)
    return data


#: (section, values, message) the JAX package rejects with ValueError
INVALID = [
    ("base", dict(batch_size=0), "batch_size"),
    ("base", dict(n_steps=-1), "n_steps"),
    ("base", dict(base_lr=0.0), "base_lr"),
    ("base", dict(weight_decay=-1e-4), "weight_decay"),
    ("base", dict(warmup_steps=-1), "warmup_steps"),
    ("base", dict(grad_clip_norm=0.0), "grad_clip_norm"),
    ("base", dict(lr_schedule="linear"), "lr_schedule"),
    ("base", dict(lr_final_fraction=1.5), "lr_final_fraction"),
    ("model", dict(condition_dimension=3), "must be even"),
    ("model", dict(architecture="transformer"), "architecture"),
    ("model", dict(architecture_options="not-a-dict"),
     "architecture_options"),
    ("model", dict(num_blocks=0), "num_blocks"),
    ("model", dict(latent_dimension=-2), "latent_dimension"),
    ("dataset", dict(dataset="cifar"), "dataset"),
    ("dataset", dict(tokenization_strategy="wavelet"),
     "tokenization_strategy"),
    ("method", dict(noise_min=1.5), "noise_min"),
    ("method", dict(noise_max=0.0), "noise_max"),
    ("method", dict(noise_min=0.9, noise_max=0.5), "must be <"),
    ("method", dict(method="improved_mean_flow"), "use_improved_mean_flow"),
    ("method", dict(method="diffusion"), "method"),
    ("method", dict(loss_strategy="diffusion"), "loss_strategy"),
    ("method", dict(noise_schedule="cosine"), "noise_schedule"),
    ("method", dict(time_sampling="beta"), "time_sampling"),
    ("method", dict(loss_weighting="focal"), "loss_weighting"),
    ("method", dict(qat_mode="dither"), "qat_mode"),
    ("method", dict(gamma=0.0), "gamma"),
    ("method", dict(c=-1.0), "c must"),
    ("method", dict(flow_ratio=0.0), "flow_ratio"),
    ("method", dict(time_sampling_std=0.0), "time_sampling_std"),
    ("method", dict(qat_step_frac=0.0), "qat_step_frac"),
    ("method", dict(qat_bits=3), "qat_bits"),
    ("method", dict(qat_bits=8, qat_step_frac=0.5), "at most one"),
    ("method", dict(time_sampling_data_proportion=1.5),
     "time_sampling_data_proportion"),
    ("method", dict(time_sampling_full_proportion=-0.1),
     "time_sampling_full_proportion"),
    ("method", dict(time_sampling_full_proportion=0.6), "must not exceed 1"),
    ("method", dict(flow_ratio=0.7, time_sampling_full_proportion=0.4),
     "must not exceed 1"),
    ("training", dict(sample_every=0), "sample_every"),
    ("training", dict(sample_steps=0), "sample_steps"),
    ("training", dict(checkpoint_step=0), "checkpoint_step"),
    ("training", dict(max_checkpoints_to_keep=0), "max_checkpoints_to_keep"),
    ("training", dict(checkpoint_format="pickle"), "checkpoint_format"),
    ("training", dict(ema_decay=1.0), "ema_decay"),
    ("tpu", dict(precision="fp8"), "precision"),
    ("tpu", dict(mesh_model=0), "mesh_model"),
    ("tpu", dict(mesh_data=0), "mesh_data"),
    ("tpu", dict(steps_per_call=0), "steps_per_call"),
]


@pytest.mark.parametrize("section,values,message", INVALID,
                         ids=[f"{s}-{'-'.join(v)}" for s, v, _ in INVALID])
def test_invalid_values_are_rejected_as_jax_rejects_them(section, values,
                                                         message):
    data = copy.deepcopy(VALID)
    data.setdefault(section, {}).update(values)
    with pytest.raises(ValueError, match=message):
        jconfigs.TrainFlowConfig.from_dict(data)
    with pytest.raises(ValueError, match=message):
        configs.config_from_dict(data)


def test_replace_is_validated():
    import dataclasses

    config = configs.config_from_dict(VALID)
    with pytest.raises(ValueError, match="ema_decay"):
        dataclasses.replace(config, ema_decay=2.0)


def test_unknown_fields_and_bad_formats_raise_as_jax():
    data = _with("base", learning_rate=1.0)
    with pytest.raises(TypeError):
        jconfigs.TrainFlowConfig.from_dict(data)
    with pytest.raises(TypeError, match="learning_rate"):
        configs.config_from_dict(data)
    for module_call in (jconfigs.TrainFlowConfig.from_dict,
                        configs.config_from_dict):
        with pytest.raises(ValueError, match="Invalid config format"):
            module_call({"something": 1})


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=[p.name for p in CONFIG_FILES])
def test_every_config_file_reads_as_jax_reads_it(path):
    assert configs.load_config(path).to_dict() == (
        jconfigs.load_config_from_json(path).to_dict())


V1 = {"batch_size": 16, "n_steps": 50, "base_lr": 1e-3, "weight_decay": 0.0,
      "seed": 1, "noise_dimension": 784, "condition_dimension": 64,
      "latent_dimension": 32, "num_blocks": 2, "architecture": "mlp",
      "dataset": "mnist", "use_improved_mean_flow": True, "gamma": 1.0,
      "sample_every": 10, "sample_seed": 0, "sample_steps": 5,
      "workdir": "/tmp/v1_run", "method": "improved_mean_flow",
      "precision": "float32", "steps_per_call": 4}


@pytest.mark.parametrize("flat", [
    V1,
    {k: v for k, v in V1.items() if k != "workdir"} | {
        "output_dir": "/tmp/out", "run_name": "r1"},
    {k: v for k, v in V1.items() if k != "workdir"} | {
        "output_dir": "/tmp/out"},
], ids=["workdir", "output_dir+run_name", "output_dir"])
def test_v1_flat_configs_migrate_as_jax(flat, tmp_path):
    assert configs.migrate_config_v1_to_v2(flat) == (
        jconfigs.migrate_config_v1_to_v2(flat))
    with pytest.warns(DeprecationWarning) if "output_dir" in flat else (
            _no_warning()):
        ours = configs.config_from_dict(flat)
    with pytest.warns(DeprecationWarning) if "output_dir" in flat else (
            _no_warning()):
        ref = jconfigs.TrainFlowConfig.from_dict(flat)
    assert ours.to_dict() == ref.to_dict()
    assert (ours.batch_size, ours.steps_per_call, ours.precision) == (
        16, 4, "float32")
    path = tmp_path / "v1.json"
    path.write_text(json.dumps(flat))
    assert configs.load_config(path) == ours


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


MERGES = [
    {"base": {"batch_size": 64}},
    {"batch_size": 64, "gamma": 0.5, "precision": "bfloat16"},
    {"dataset": "audio", "method": "mean_flow"},
    {"dataset": {"tokenization_strategy": "mdct",
                 "tokenization_config": {"window_size": 256}}},
    {"method": {"method": "improved_mean_flow",
                "use_improved_mean_flow": True}, "workdir": "./runs/x/"},
    {"architecture_options": {"channels": 16}, "ema_decay": 0.99,
     "config_version": "1.0"},
]


@pytest.mark.parametrize("override", MERGES, ids=range(len(MERGES)))
def test_merges_match_jax(override):
    ours = configs.merge_configs(configs.config_from_dict(VALID), override)
    ref = jconfigs.merge_configs(jconfigs.TrainFlowConfig.from_dict(VALID),
                                 copy.deepcopy(override))
    assert ours.to_dict() == ref.to_dict()


def test_diff_matches_jax():
    pairs = [(VALID, _with("base", batch_size=8)),
             (VALID, _with("method", gamma=0.5)),
             (_with("method", gamma=0.5), VALID)]
    for a, b in pairs:
        ours = configs.diff_configs(configs.config_from_dict(a),
                                    configs.config_from_dict(b))
        ref = jconfigs.diff_configs(jconfigs.TrainFlowConfig.from_dict(a),
                                    jconfigs.TrainFlowConfig.from_dict(b))
        assert ours == ref


@pytest.mark.parametrize("factory", ["create_mnist_config",
                                     "create_audio_config"])
@pytest.mark.parametrize("overrides", [
    {}, {"batch_size": 8, "architecture": "convnet"},
    {"model": {"num_blocks": 2}, "method": {"method": "flow_matching"}}],
    ids=["defaults", "flat", "sections"])
def test_factories_match_jax(factory, overrides, tmp_path):
    ours = getattr(configs, factory)(**copy.deepcopy(overrides))
    ref = getattr(jconfigs, factory)(**copy.deepcopy(overrides))
    assert ours.to_dict() == ref.to_dict()
    configs.save_config_to_json(ours, tmp_path / "ours.json")
    jconfigs.save_config_to_json(ref, tmp_path / "ref.json")
    assert (tmp_path / "ours.json").read_bytes() == (
        tmp_path / "ref.json").read_bytes()
    assert jconfigs.load_config_from_json(
        tmp_path / "ours.json").to_dict() == ref.to_dict()


def test_evaluation_and_analysis_configs():
    evaluation = configs.EvaluationConfig(checkpoint=Path("c.msgpack"))
    assert evaluation.n_steps == [1, 10, 50, 250]
    assert evaluation.num_samples == 1000
    with pytest.warns(DeprecationWarning):
        analysis = configs.AnalysisConfig(metrics_csv=Path("m.csv"),
                                          output_dir=Path("out"))
    assert analysis.workdir == Path("out")
    with pytest.raises(ValueError):
        configs.AnalysisConfig(metrics_csv=Path("m.csv"))


# ---------------------------------------------------------------------------
# the flag-driven CLI against the root CLI
# ---------------------------------------------------------------------------

FRONTIER_OPTIONS = json.dumps({"channels": 256, "bottleneck_dim": 512,
                               "spatial": 8, "lift_channels": 32,
                               "remat": True,
                               "remat_policy": "dots_saveable"})
ARGV = {
    "mnist-mlp": ["--dataset", "mnist", "--architecture", "mlp",
                  "--method", "mean_flow", "--gamma", "0.5"],
    "mnist-mixer": ["--dataset", "mnist", "--architecture", "mlp_mixer",
                    "--method", "flow_matching", "--base-lr", "3e-4",
                    "--lr-schedule", "cosine", "--warmup-steps", "10"],
    "mnist-convnet-imf": ["--architecture", "convnet", "--method",
                          "improved_mean_flow", "--num-blocks", "2",
                          "--condition-dimension", "32", "--ema-decay",
                          "0.999", "--skip-nonfinite"],
    "mnist-simple-conv": ["--dataset", "mnist", "--architecture",
                          "simple_conv", "--method", "autoencoder",
                          "--precision", "float32"],
    "audio-mlp": ["--dataset", "audio", "--architecture", "mlp",
                  "--method", "improved_mean_flow", "--frame-size", "8192",
                  "--window-size", "256", "--coeff-scale", "2"],
    "audio-mixer": ["--dataset", "audio", "--architecture", "mlp_mixer",
                    "--tokenization", "mdct", "--latent-dimension", "64",
                    "--pool-batches", "4", "--device-pool-clips", "0",
                    "--data-dir", "/nonexistent", "--resample-audio"],
    "audio-convnet-frontier": [
        "--dataset", "audio", "--method", "improved_mean_flow",
        "--architecture", "convnet", "--architecture-options",
        FRONTIER_OPTIONS, "--condition-dimension", "256",
        "--latent-dimension", "256", "--num-blocks", "8", "--frame-size",
        "32768", "--window-size", "512", "--coeff-scale", "4",
        "--batch-size", "16", "--n-steps", "16", "--steps-per-call", "8",
        "--precision", "bfloat16", "--full-interval-proportion", "0.25",
        "--grad-clip-norm", "1.0", "--lr-final-fraction", "0.05"],
    "audio-simple-conv-reshape": [
        "--dataset", "audio", "--architecture", "simple_conv",
        "--tokenization", "reshape", "--noise-dimension", "4096",
        "--weight-decay", "0", "--seed", "7", "--sample-every", "5",
        "--sample-steps", "2", "--sample-seed", "3", "--checkpoint-step",
        "4", "--max-checkpoints-to-keep", "1"],
    "config-overrides": ["--config", str(REPO / "configs" /
                                         "frontier_v2.json"),
                         "--method", "mean_flow", "--gamma", "0.25",
                         "--window-size", "256", "--architecture-options",
                         '{"channels": 64}', "--n-steps", "8"],
    "config-v1-migration": ["--config", "V1_FILE", "--batch-size", "4"],
}


@pytest.mark.parametrize("name", list(ARGV))
def test_cli_configs_match_the_root_cli(name, tmp_path):
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps(V1))
    argv = [str(v1) if a == "V1_FILE" else a for a in ARGV[name]]
    argv += ["--workdir", str(tmp_path / "run")]
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    ref = ROOT.config_from_args(ROOT.build_parser().parse_args(argv))
    assert ours.to_dict() == ref.to_dict()


def test_the_flag_driven_frontier_run_builds_frontier_v2(tmp_path):
    """The flag-only audio run of the frontier geometry builds the model of
    configs/frontier_v2.json: 33,813,696 parameters once the trainer sets
    the tokenized width (1024 for W 512 stereo, where create_audio_config
    says 256*256*3)."""
    import torch

    from meanflow_audio_codec_torch.models.factories import create_flow_model
    from meanflow_audio_codec_torch.training.trainer import (
        effective_noise_dimension,
    )

    argv = ARGV["audio-convnet-frontier"] + ["--workdir", str(tmp_path)]
    config = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert config.noise_dimension == 256 * 256 * 3
    assert effective_noise_dimension(config) == 1024
    import dataclasses

    with torch.device("meta"):
        model = create_flow_model(dataclasses.replace(config,
                                                      noise_dimension=1024))
    assert sum(p.numel() for p in model.parameters()) == 33_813_696


@pytest.mark.parametrize("flag", [a for a in ROOT.build_parser()._option_string_actions
                                  if a.startswith("--") and a != "--help"])
def test_the_cli_takes_every_root_flag(flag):
    """The port's parser has every option of the root CLI's, with the same
    destination, type, choices and default."""
    ours = cli.build_parser()._option_string_actions[flag]
    ref = ROOT.build_parser()._option_string_actions[flag]
    assert (ours.dest, ours.type, ours.choices, ours.default, ours.nargs,
            ours.const) == (ref.dest, ref.type, ref.choices, ref.default,
                            ref.nargs, ref.const)


def test_main_trains_the_flag_driven_config(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(cli, "train_flow",
                        lambda config, resume: seen.append((config, resume)))
    argv = ARGV["audio-convnet-frontier"] + ["--workdir", str(tmp_path),
                                             "--resume"]
    assert cli.main(argv) == 0
    (config, resume), = seen
    assert resume is True
    assert (config.dataset, config.architecture, config.batch_size,
            config.steps_per_call, config.use_improved_mean_flow) == (
        "audio", "convnet", 16, 8, True)
