"""The v2 hierarchical JSON config: reading, validation, v1 migration, merge,
diff, the two factories and writing.

Counterpart of ``meanflow_audio_codec_tpu/configs/config.py``. One type,
:class:`CodecConfig`, holds every field the port reads: the model
(``model.*`` with ``architecture_options``), the data
(``dataset.*``), the optimiser (``base.*``), the run (``training.*``), the
objective (``method.*``) and ``tpu.precision``/``remat``/
``skip_nonfinite_updates``/``steps_per_call``. The v2 dict it was read from
is kept whole in ``source``; ``tpu.mesh_data`` and ``mesh_model`` are read
from there (:attr:`CodecConfig.mesh_data`, :attr:`CodecConfig.mesh_model`),
``donate`` is not read.

Reading does what the JAX package's ``TrainFlowConfig.from_dict`` does: a
v1 flat dict is lifted into the v2 layout (:func:`migrate_config_v1_to_v2`),
each section's defaults are filled in and its unset (``None``) fields left
out, a field a section does not have raises ``TypeError``, the deprecated
``output_dir``/``run_name`` become ``training.workdir``, and every value the
JAX package's ``validate()`` rejects raises ``ValueError`` (also on
``dataclasses.replace``). One leniency: a dict that holds only a ``model``
section (all the codec reads) is accepted, where the JAX package needs the
``base`` and ``training`` sections and their required fields.

:meth:`CodecConfig.to_dict` writes the v2 dict back (:func:`save_config_to_json`
with JAX's ``indent=2, sort_keys=True``), so the JAX package's
``load_config_from_json`` reads what the port writes, and the port's
factories and merges write the JAX package's files byte for byte.
"""

from __future__ import annotations

import copy
import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

#: name -> allowed values (the JAX package's ``_CHOICES``)
_CHOICES: dict[str, list[str]] = {
    "architecture": ["mlp", "mlp_mixer", "convnet", "simple_conv"],
    "dataset": ["mnist", "audio", "synthetic"],
    "tokenization_strategy": ["mdct", "reshape"],
    "method": ["autoencoder", "flow_matching", "mean_flow",
               "improved_mean_flow"],
    "loss_strategy": ["flow_matching", "mean_flow", "improved_mean_flow"],
    "noise_schedule": ["linear", "uniform"],
    "time_sampling": ["uniform", "logit_normal", "mean_flow"],
    "loss_weighting": ["uniform", "time_dependent", "learned"],
    "qat_mode": ["ste", "noise"],
    "precision": ["float32", "bfloat16", "mixed"],
    "checkpoint_format": ["msgpack", "orbax"],
}
LR_SCHEDULES = ("constant", "cosine")

#: a field without a default (the JAX dataclass's required fields)
_REQUIRED = object()
#: section -> field -> default, in the JAX dataclasses' order
_FIELDS: dict[str, dict[str, Any]] = {
    "base": {"batch_size": _REQUIRED, "n_steps": _REQUIRED,
             "base_lr": _REQUIRED, "weight_decay": _REQUIRED,
             "seed": _REQUIRED, "grad_clip_norm": None, "warmup_steps": 0,
             "lr_schedule": "constant", "lr_final_fraction": 0.0},
    "model": {"noise_dimension": _REQUIRED, "condition_dimension": _REQUIRED,
              "latent_dimension": _REQUIRED, "num_blocks": _REQUIRED,
              "architecture": None, "architecture_options": None},
    "dataset": {"dataset": None, "data_dir": None,
                "tokenization_strategy": None, "tokenization_config": None,
                "resample_audio": False},
    "method": {"method": None, "use_improved_mean_flow": False,
               "gamma": None, "flow_ratio": None, "c": None,
               "use_stop_gradient": None, "loss_weighting": None,
               "loss_strategy": None, "noise_schedule": None,
               "noise_min": None, "noise_max": None, "time_sampling": None,
               "time_sampling_mean": None, "time_sampling_std": None,
               "time_sampling_data_proportion": None,
               "time_sampling_full_proportion": None,
               "use_weighted_loss": None, "qat_mode": None,
               "qat_step_frac": None, "qat_bits": None},
    "training": {"sample_every": _REQUIRED, "sample_seed": _REQUIRED,
                 "sample_steps": _REQUIRED, "workdir": None,
                 "checkpoint_step": None, "max_checkpoints_to_keep": None,
                 "checkpoint_format": None, "ema_decay": None,
                 "sample_guidance_scale": None},
    "tpu": {"mesh_data": -1, "mesh_model": 1, "precision": "mixed",
            "remat": False, "donate": True, "steps_per_call": 1,
            "skip_nonfinite_updates": False},
}
#: fields kept in ``source`` only (the mesh sizes are read from there)
_NOT_READ = ("mesh_data", "mesh_model", "donate")
#: dict fields: an empty one is written back only when the source had it
_DICT_FIELDS = ("architecture_options", "tokenization_config")

#: flat field -> the section holding it (flat overrides, as in JAX)
_FLAT_LOOKUP: dict[str, str] = {}
for _section, _names in _FIELDS.items():
    for _name in _names:
        _FLAT_LOOKUP.setdefault(_name, _section)
_FLAT_LOOKUP["dataset"] = "dataset"
_FLAT_LOOKUP["method"] = "method"


@dataclass(frozen=True)
class CodecConfig:
    """Every field of a v2 config that the port reads."""

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
        validate(self.to_dict())

    @property
    def mesh_data(self) -> int:
        """``tpu.mesh_data``: the data axis of the mesh, -1 for every rank
        the model axis leaves."""
        return int((self.source.get("tpu") or {}).get("mesh_data", -1))

    @property
    def mesh_model(self) -> int:
        """``tpu.mesh_model``: the tensor-parallel axis of the mesh."""
        return int((self.source.get("tpu") or {}).get("mesh_model", 1))

    def to_dict(self) -> dict:
        """The v2 hierarchical dict of this config: the source dict with every
        field the port reads written over it (unset fields left out)."""
        out = copy.deepcopy(self.source)
        out.setdefault("config_version", "2.0")
        for section, names in _FIELDS.items():
            target = out.setdefault(section, {})
            for name in names:
                if name in _NOT_READ:
                    continue
                value = getattr(self, name)
                if name == "workdir" and value is not None:
                    value = str(Path(value))
                if value is None or (name in _DICT_FIELDS and not value
                                     and name not in target):
                    target.pop(name, None)
                else:
                    target[name] = copy.deepcopy(value)
        return out


# ============================================================================
# Validation (the JAX package's section validate() methods)
# ============================================================================


def _choice(section: dict, name: str) -> None:
    value = section.get(name)
    if value is not None and value not in _CHOICES[name]:
        raise ValueError(f"{name} must be one of {_CHOICES[name]}, "
                         f"got {value!r}")


def _positive(section: dict, *names: str) -> None:
    for name in names:
        value = section.get(name)
        if value is not None and value <= 0:
            raise ValueError(f"{name} must be > 0, got {value}")


def _nonnegative(section: dict, *names: str) -> None:
    for name in names:
        value = section.get(name)
        if value is not None and value < 0:
            raise ValueError(f"{name} must be >= 0, got {value}")


def _validate_base(s: dict) -> None:
    _positive(s, "batch_size", "n_steps", "base_lr")
    _nonnegative(s, "weight_decay", "warmup_steps")
    if s.get("grad_clip_norm") is not None and s["grad_clip_norm"] <= 0:
        raise ValueError(
            f"grad_clip_norm must be positive, got {s['grad_clip_norm']}")
    schedule = s.get("lr_schedule", "constant")
    if schedule not in LR_SCHEDULES:
        raise ValueError("lr_schedule must be 'constant' or 'cosine', "
                         f"got {schedule!r}")
    fraction = s.get("lr_final_fraction", 0.0)
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"lr_final_fraction must be in [0, 1], got {fraction}")


def _validate_model(s: dict) -> None:
    _positive(s, "noise_dimension", "condition_dimension", "latent_dimension",
              "num_blocks")
    if s.get("condition_dimension") is not None and (
            s["condition_dimension"] % 2 != 0):
        raise ValueError("condition_dimension must be even, got "
                         f"{s['condition_dimension']}")
    _choice(s, "architecture")
    options = s.get("architecture_options")
    if options is not None and not isinstance(options, dict):
        raise ValueError("architecture_options must be a dict, got "
                         f"{type(options).__name__}")


def _validate_dataset(s: dict) -> None:
    _choice(s, "dataset")
    _choice(s, "tokenization_strategy")


def _validate_method(s: dict) -> None:
    for name in ("method", "loss_strategy", "noise_schedule",
                 "time_sampling", "loss_weighting", "qat_mode"):
        _choice(s, name)
    _positive(s, "gamma", "flow_ratio", "c", "time_sampling_std",
              "qat_step_frac")
    get = s.get
    if get("qat_step_frac") is not None and get("qat_bits") is not None:
        raise ValueError("set at most one of qat_step_frac / qat_bits")
    if get("qat_bits") is not None and get("qat_bits") not in (4, 8, 16):
        raise ValueError(f"qat_bits must be 4, 8 or 16, got {get('qat_bits')}")
    lo, hi = get("noise_min"), get("noise_max")
    if lo is not None and not 0 <= lo < 1:
        raise ValueError(f"noise_min must be in [0, 1), got {lo}")
    if hi is not None and not 0 < hi <= 1:
        raise ValueError(f"noise_max must be in (0, 1], got {hi}")
    if lo is not None and hi is not None and lo >= hi:
        raise ValueError(f"noise_min ({lo}) must be < noise_max ({hi})")
    data = get("time_sampling_data_proportion")
    if data is not None and not 0 <= data <= 1:
        raise ValueError("time_sampling_data_proportion must be in [0, 1], "
                         f"got {data}")
    full = get("time_sampling_full_proportion")
    if full is not None and not 0 <= full <= 1:
        raise ValueError("time_sampling_full_proportion must be in [0, 1], "
                         f"got {full}")
    # the effective data proportion (flow_ratio, else 0.5, when unset)
    effective = data if data is not None else (
        get("flow_ratio") if get("flow_ratio") is not None else 0.5)
    if effective + (full or 0) > 1:
        raise ValueError(
            f"time_sampling_data_proportion (effective {effective}, default "
            "0.5 when unset) + time_sampling_full_proportion must not "
            "exceed 1")
    if get("method") == "improved_mean_flow" and not get(
            "use_improved_mean_flow"):
        raise ValueError(
            "method='improved_mean_flow' requires use_improved_mean_flow=True")


def _validate_training(s: dict) -> None:
    _positive(s, "sample_every", "sample_steps", "checkpoint_step",
              "max_checkpoints_to_keep")
    _choice(s, "checkpoint_format")
    decay = s.get("ema_decay")
    if decay is not None and not 0.0 < decay < 1.0:
        raise ValueError(f"ema_decay must be in (0, 1), got {decay}")


def _validate_tpu(s: dict) -> None:
    _choice(s, "precision")
    _positive(s, "mesh_model", "steps_per_call")
    if s.get("mesh_data") == 0:
        raise ValueError("mesh_data must be -1 or positive, got 0")


_VALIDATORS = {"base": _validate_base, "model": _validate_model,
               "dataset": _validate_dataset, "method": _validate_method,
               "training": _validate_training, "tpu": _validate_tpu}


def validate(data: dict) -> None:
    """Raise ``ValueError`` on every value of a v2 dict that the JAX
    package's section ``validate()`` methods reject."""
    for section, check in _VALIDATORS.items():
        check(data.get(section) or {})


# ============================================================================
# Reading: migration, normalisation, loading
# ============================================================================

_V1_SECTION_KEYS: dict[str, tuple[str, ...]] = {
    "base": ("batch_size", "n_steps", "base_lr", "weight_decay", "seed"),
    "model": ("noise_dimension", "condition_dimension", "latent_dimension",
              "num_blocks", "architecture"),
    "dataset": ("dataset", "data_dir", "tokenization_strategy",
                "tokenization_config"),
    "method": tuple(_FIELDS["method"]),
    "training": ("sample_every", "sample_seed", "sample_steps", "workdir",
                 "checkpoint_step", "max_checkpoints_to_keep",
                 "checkpoint_format", "ema_decay", "sample_guidance_scale"),
    "tpu": ("mesh_data", "mesh_model", "precision", "remat", "donate",
            "steps_per_call"),
}


def _is_flat(data: dict) -> bool:
    return "base" not in data and any(
        k in data for k in ("batch_size", "n_steps", "base_lr"))


def migrate_config_v1_to_v2(data: dict) -> dict:
    """Lift a flat v1 config dict into the hierarchical v2 layout."""
    result: dict[str, Any] = {"config_version": "2.0"}
    for section, keys in _V1_SECTION_KEYS.items():
        picked = {k: data[k] for k in keys if k in data}
        if section == "method":
            picked.setdefault("use_improved_mean_flow", False)
        if picked or section in ("base", "model", "training", "method"):
            result[section] = picked
    for passthrough in ("output_dir", "run_name"):
        if passthrough in data:
            result[passthrough] = data[passthrough]
    return result


def _normalize(data: dict) -> dict:
    """The v2 dict the JAX package's ``TrainFlowConfig.from_dict(data)
    .to_dict()`` gives: sections in order with their defaults, unset fields
    left out, ``workdir`` as a normalised path string."""
    if not isinstance(data, dict):
        raise ValueError("Invalid config format: expected a dict")
    if _is_flat(data):
        data = migrate_config_v1_to_v2(data)
    if "model" not in data:
        raise ValueError("Invalid config format: expected a v2 hierarchical "
                         "config with a 'model' section")
    out: dict[str, Any] = {"config_version": data.get("config_version",
                                                      "2.0")}
    for section, defaults in _FIELDS.items():
        given = data.get(section) or {}
        unknown = sorted(set(given) - set(defaults))
        if unknown:
            raise TypeError(f"the {section} section has no field {unknown}")
        values = {name: given.get(name, default)
                  for name, default in defaults.items()
                  if name in given or default is not _REQUIRED}
        out[section] = {k: v for k, v in values.items() if v is not None}
    training = out["training"]
    if "workdir" not in training and data.get("output_dir"):
        warnings.warn("output_dir and run_name are deprecated. Use workdir "
                      "instead.", DeprecationWarning, stacklevel=3)
        run_name = data.get("run_name") or "seed{}_{}".format(
            out["base"].get("seed"),
            "improved" if out["method"].get("use_improved_mean_flow")
            else "baseline")
        training["workdir"] = Path(data["output_dir"]) / run_name
    if "workdir" in training:
        training["workdir"] = str(Path(training["workdir"]))
    return out


def config_from_dict(data: dict) -> CodecConfig:
    """Build a :class:`CodecConfig` from a parsed v1 or v2 config dict."""
    normalized = _normalize(data)
    validate(normalized)
    values = {name: normalized[section][name]
              for section, names in _FIELDS.items() for name in names
              if name not in _NOT_READ and name in normalized[section]}
    missing = [name for name in list(_FIELDS["model"])[:4]
               if name not in values]
    if missing:
        raise ValueError(f"the model section needs {missing}")
    for name in _DICT_FIELDS:
        values[name] = dict(values.get(name) or {})
    return CodecConfig(**values, source=normalized)


def load_config(path: Path | str) -> CodecConfig:
    """Read a v1 or v2 JSON config file."""
    with Path(path).open("r", encoding="utf-8") as f:
        return config_from_dict(json.load(f))


def save_config_to_json(config: CodecConfig, path: Path | str) -> None:
    """Write a config as v2 hierarchical JSON, as the JAX package writes it."""
    with Path(path).open("w", encoding="utf-8") as f:
        json.dump(config.to_dict(), f, indent=2, sort_keys=True)


# ============================================================================
# Merge and diff
# ============================================================================


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def merge_configs(config: CodecConfig, override: dict) -> CodecConfig:
    """``config`` with an override dict deep-merged into its v2 dict: a
    hierarchical one (``{"base": {...}, ...}``) or flat keys, each lifted
    into the section holding it (``dataset``/``method`` as a dict are the
    sections, as a string the fields)."""
    if "base" not in override:
        lifted: dict[str, Any] = {}
        for key, value in override.items():
            section = _FLAT_LOOKUP.get(key)
            if section is not None and not (
                    key in _FIELDS and isinstance(value, dict)):
                lifted.setdefault(section, {})[key] = value
            else:
                lifted[key] = value
        override = lifted
        override.pop("config_version", None)
    return config_from_dict(_deep_merge(config.to_dict(), override))


def _flatten(d: dict, prefix: str = "") -> dict:
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def diff_dicts(old: dict, new: dict) -> dict:
    """``{'changed': {...}, 'added': [...], 'removed': [...]}`` between two
    v2 config dicts, by dotted field name."""
    flat1, flat2 = _flatten(old), _flatten(new)
    changed = {key: {"old": flat1[key], "new": flat2[key]}
               for key in flat1.keys() & flat2.keys()
               if flat1[key] != flat2[key]}
    return {"changed": changed,
            "added": sorted(flat2.keys() - flat1.keys()),
            "removed": sorted(flat1.keys() - flat2.keys())}


def diff_configs(config1: CodecConfig, config2: CodecConfig) -> dict:
    """Compare two configs (:func:`diff_dicts` of their v2 dicts)."""
    return diff_dicts(config1.to_dict(), config2.to_dict())


# ============================================================================
# Factories and the evaluation configs
# ============================================================================


def _default_config(noise_dimension: int, dataset: str, tokenization: str,
                    workdir: str, overrides: dict) -> CodecConfig:
    config = config_from_dict({
        "base": {"batch_size": 128, "n_steps": 10000, "base_lr": 1e-4,
                 "weight_decay": 1e-4, "seed": 42},
        "model": {"noise_dimension": noise_dimension,
                  "condition_dimension": 128, "latent_dimension": 256,
                  "num_blocks": 8},
        "dataset": {"dataset": dataset,
                    "tokenization_strategy": tokenization},
        "method": {"use_improved_mean_flow": False},
        "training": {"sample_every": 1000, "sample_seed": 42,
                     "sample_steps": 50, "workdir": workdir},
    })
    return merge_configs(config, overrides) if overrides else config


def create_mnist_config(**overrides) -> CodecConfig:
    """Default MNIST configuration (reshape tokenization)."""
    return _default_config(784, "mnist", "reshape", "./outputs/mnist_default",
                           overrides)


def create_audio_config(**overrides) -> CodecConfig:
    """Default audio configuration (MDCT tokenization; the trainer sets the
    model width to the tokenized one)."""
    return _default_config(256 * 256 * 3, "audio", "mdct",
                           "./outputs/audio_default", overrides)


@dataclass
class EvaluationConfig:
    """Evaluation run configuration."""

    checkpoint: Path
    config_path: Path | None = None
    output_dir: Path | None = None
    n_steps: list[int] = field(default_factory=lambda: [1, 10, 50, 250])
    num_samples: int = 1000
    batch_size: int = 128
    seed: int = 42
    metrics_csv: Path = Path("metrics.csv")
    data_dir: str | None = None
    real_split: str = "test"
    use_improved_mean_flow: bool | None = None
    noise_dimension: int | None = None
    condition_dimension: int | None = None
    latent_dimension: int | None = None
    num_blocks: int | None = None


@dataclass
class AnalysisConfig:
    """Post-hoc analysis configuration."""

    metrics_csv: Path
    workdir: Path | None = None
    output_dir: Path | None = None

    def __post_init__(self) -> None:
        if self.workdir is None:
            if self.output_dir is None:
                raise ValueError("Either workdir or output_dir must be provided")
            warnings.warn("output_dir is deprecated. Use workdir instead.",
                          DeprecationWarning, stacklevel=2)
            self.workdir = self.output_dir
