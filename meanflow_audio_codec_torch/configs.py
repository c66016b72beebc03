"""Reader of the v2 hierarchical JSON config, limited to the fields the port uses.

Counterpart of ``meanflow_audio_codec_tpu/configs/config.py``, which
validates and migrates every field. The port reads what the codec round trip
needs (``model.*`` with ``architecture_options``, ``dataset.dataset``,
``dataset.tokenization_strategy``, ``dataset.tokenization_config``,
``tpu.precision``), what the train step needs (the optimiser's ``base.*``,
``training.ema_decay``, the objective's ``method.*``, ``tpu.remat`` and
``tpu.skip_nonfinite_updates``) and what the trainer needs (``base.seed``,
``dataset.data_dir``/``resample_audio``, the run's ``training.*`` and
``tpu.steps_per_call``). An absent field takes the JAX package's default;
``None`` means "unset", and the consumer applies the default the JAX package
applies there (``training/objectives.create_loss_strategy``).

:meth:`CodecConfig.to_dict` writes the v2 dict back: the dict the config was
read from, with every field the port reads set to its current value, so the
JAX package's ``load_config_from_json`` reads a ``config.json`` the port's
trainer writes. :func:`merge_configs` deep-merges a hierarchical override
dict into a config, as the JAX package's ``merge_configs`` does.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from pathlib import Path

PRECISIONS = ("float32", "bfloat16", "mixed")
LR_SCHEDULES = ("constant", "cosine")
#: config section -> fields the port reads from it
_SECTIONS = {
    "model": ("noise_dimension", "condition_dimension", "latent_dimension",
              "num_blocks", "architecture", "architecture_options"),
    "dataset": ("dataset", "data_dir", "tokenization_strategy",
                "tokenization_config", "resample_audio"),
    "base": ("batch_size", "n_steps", "base_lr", "weight_decay", "seed",
             "warmup_steps", "lr_schedule", "lr_final_fraction",
             "grad_clip_norm"),
    "training": ("ema_decay", "workdir", "sample_every", "sample_seed",
                 "sample_steps", "sample_guidance_scale", "checkpoint_step",
                 "max_checkpoints_to_keep", "checkpoint_format"),
    "method": ("method", "use_improved_mean_flow", "loss_strategy",
               "noise_schedule", "noise_min", "noise_max", "time_sampling",
               "time_sampling_mean", "time_sampling_std",
               "time_sampling_data_proportion", "flow_ratio",
               "time_sampling_full_proportion", "use_weighted_loss",
               "use_stop_gradient", "loss_weighting", "gamma", "c",
               "qat_mode", "qat_step_frac", "qat_bits"),
    "tpu": ("precision", "remat", "skip_nonfinite_updates",
            "steps_per_call"),
}


@dataclass(frozen=True)
class CodecConfig:
    """The slice of a v2 config that the codec, the train step and the
    trainer read."""

    noise_dimension: int
    condition_dimension: int
    latent_dimension: int
    num_blocks: int
    architecture: str | None = None
    architecture_options: dict = field(default_factory=dict)
    dataset: str | None = None
    data_dir: str | None = None
    tokenization_strategy: str | None = None
    tokenization_config: dict = field(default_factory=dict)
    resample_audio: bool = False
    #: compute precision; the JAX package defaults to "mixed" (bf16 compute)
    precision: str = "mixed"

    # base.*: the optimiser (the JAX package requires the first five)
    batch_size: int | None = None
    n_steps: int | None = None
    base_lr: float | None = None
    weight_decay: float | None = None
    seed: int | None = None
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    lr_final_fraction: float = 0.0
    grad_clip_norm: float | None = None
    # training.*: EMA, run directory, sampling and checkpoints
    ema_decay: float | None = None
    workdir: str | None = None
    sample_every: int | None = None
    sample_seed: int | None = None
    sample_steps: int | None = None
    sample_guidance_scale: float | None = None
    checkpoint_step: int | None = None
    max_checkpoints_to_keep: int | None = None
    checkpoint_format: str | None = None
    # method.*: the objective
    method: str | None = None
    use_improved_mean_flow: bool = False
    loss_strategy: str | None = None
    noise_schedule: str | None = None
    noise_min: float | None = None
    noise_max: float | None = None
    time_sampling: str | None = None
    time_sampling_mean: float | None = None
    time_sampling_std: float | None = None
    time_sampling_data_proportion: float | None = None
    flow_ratio: float | None = None
    time_sampling_full_proportion: float | None = None
    use_weighted_loss: bool | None = None
    use_stop_gradient: bool | None = None
    loss_weighting: str | None = None
    #: mean flow's adaptive weight sg(1/(mse + c)^(1 - gamma))
    gamma: float | None = None
    c: float | None = None
    qat_mode: str | None = None
    qat_step_frac: float | None = None
    qat_bits: int | None = None
    # tpu.*: recompute the whole loss in the backward pass; drop updates
    # whose loss, gradient norm or parameters are not finite; train steps
    # per call of the step function
    remat: bool = False
    skip_nonfinite_updates: bool = False
    steps_per_call: int = 1
    #: the v2 dict the config was read from (sections and fields the port
    #: does not read included); ``to_dict`` writes the fields over it
    source: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self) -> None:
        for name in ("noise_dimension", "condition_dimension",
                     "latent_dimension", "num_blocks"):
            value = getattr(self, name)
            if not isinstance(value, int) or value <= 0:
                raise ValueError(f"{name} must be a positive int, got {value!r}")
        if self.condition_dimension % 2:
            raise ValueError("condition_dimension must be even, got "
                             f"{self.condition_dimension}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {self.precision!r}")
        if self.lr_schedule not in LR_SCHEDULES:
            raise ValueError(f"lr_schedule must be one of {LR_SCHEDULES}, "
                             f"got {self.lr_schedule!r}")
        if self.steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1, got "
                             f"{self.steps_per_call}")

    def to_dict(self) -> dict:
        """The v2 hierarchical dict of this config: the source dict with every
        field the port reads written over it (unset fields left out)."""
        out = copy.deepcopy(self.source)
        out.setdefault("config_version", "2.0")
        for section, names in _SECTIONS.items():
            target = out.setdefault(section, {})
            for name in names:
                value = getattr(self, name)
                if value is None:
                    target.pop(name, None)
                else:
                    target[name] = copy.deepcopy(value)
        return out


def config_from_dict(data: dict) -> CodecConfig:
    """Build a :class:`CodecConfig` from a parsed v2 config dict."""
    if not isinstance(data, dict) or "model" not in data:
        raise ValueError("Invalid config format: expected a v2 hierarchical "
                         "config with a 'model' section")
    values = {name: (data.get(section) or {})[name]
              for section, section_names in _SECTIONS.items()
              for name in section_names
              if (data.get(section) or {}).get(name) is not None}
    missing = [name for name in _SECTIONS["model"][:4] if name not in values]
    if missing:
        raise ValueError(f"the model section needs {missing}")
    for name in ("architecture_options", "tokenization_config"):
        values[name] = dict(values.get(name) or {})
    if "workdir" in values:
        values["workdir"] = str(values["workdir"])
    return CodecConfig(**values, source=copy.deepcopy(data))


def load_config(path: Path | str) -> CodecConfig:
    """Read a v2 JSON config file."""
    with Path(path).open("r", encoding="utf-8") as f:
        return config_from_dict(json.load(f))


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def merge_configs(config: CodecConfig, override: dict) -> CodecConfig:
    """``config`` with a hierarchical override dict (``{"base": {...}, ...}``)
    deep-merged into its v2 dict."""
    return config_from_dict(_deep_merge(config.to_dict(), override))
