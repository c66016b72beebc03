"""The v2 hierarchical JSON config: reading, validation, v1 migration, merge,
diff, the two factories and writing.

Counterpart of ``meanflow_audio_codec_tpu/configs/config.py``. One type,
:class:`CodecConfig`, holds every field the port reads: the model
(``model.*`` with ``architecture_options``), the data
(``dataset.*``), the optimiser (``base.*``), the run (``training.*``), the
objective (``method.*``) and ``tpu.precision``/``remat``/
``skip_nonfinite_updates``/``steps_per_call``. The v2 dict it was read from
is kept whole in ``source``; ``tpu.mesh_data``, ``mesh_model`` and
``donate`` are read from there (properties of the same names).

The JAX package's sectioned ``TrainFlowConfig`` is this same type
(``TrainFlowConfig = CodecConfig``), with section views added: ``base``,
``model``, ``dataset_config``, ``method_config``, ``training`` and ``tpu``
are :class:`Section` objects (``BaseConfig``, ``ModelConfig``, ...) built
from :meth:`CodecConfig.to_dict`, so section access and flat access
(``config.batch_size``, ``config.dataset``, the name, ...) read the same
values. The sections are frozen views: a change goes through
``dataclasses.replace`` or :func:`merge_configs`. ``TrainFlowConfig(base=...,
model=..., dataset=..., method=..., training=..., tpu=..., output_dir=...,
run_name=...)``, the JAX package's constructor, builds the same config as
reading its dict. Two flat fields read differently from the JAX package's:
``workdir`` is a ``str`` (the section's is a ``Path``, as in JAX), and
``architecture_options``/``tokenization_config`` are ``{}`` when unset (the
sections' are None, as in JAX).

Reading does what the JAX package's ``TrainFlowConfig.from_dict`` does: a
v1 flat dict is lifted into the v2 layout (:func:`migrate_config_v1_to_v2`),
each section's defaults are filled in and its unset (``None``) fields left
out, a field a section does not have raises ``TypeError``, the deprecated
``output_dir``/``run_name`` become ``training.workdir``, and every value the
JAX package's ``validate()`` rejects raises ``ValueError`` (also on
``dataclasses.replace``). The sections' ``validate()`` run the same
``_validate_*`` functions, the one validator. One leniency: a dict that
holds only a ``model`` section (all the codec reads) is accepted, where the
JAX package needs the ``base`` and ``training`` sections and their required
fields.

:meth:`CodecConfig.to_dict` writes the v2 dict back (:func:`save_config_to_json`
with JAX's ``indent=2, sort_keys=True``), so the JAX package's
``load_config_from_json`` reads what the port writes, and the port's
factories and merges write the JAX package's files byte for byte.
"""

from __future__ import annotations

import copy
import json
import warnings
from dataclasses import MISSING, dataclass, field, fields
from pathlib import Path
from typing import Any, ClassVar

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

# ============================================================================
# Sections: the JAX package's section dataclasses, read-only here
# ============================================================================


@dataclass(frozen=True)
class Section:
    """Base of the config sections: ``to_dict`` (unset fields left out),
    ``get_schema`` and ``validate`` (the section's ``_validate_*``)."""

    #: the section's key in the v2 dict
    key: ClassVar[str] = ""

    def to_dict(self) -> dict:
        return {f.name: str(value) if isinstance(value, Path) else value
                for f in fields(self)
                if (value := getattr(self, f.name)) is not None}

    def get_schema(self) -> dict:
        schema: dict[str, Any] = {}
        for f in fields(self):
            entry: dict[str, Any] = {
                "type": str(f.type),
                "required": (f.default is MISSING
                             and f.default_factory is MISSING),
                "default": None if f.default in (MISSING, None) else f.default,
            }
            if f.name in _CHOICES:
                entry["allowed_values"] = list(_CHOICES[f.name])
            schema[f.name] = entry
        return schema

    def validate(self) -> None:
        _VALIDATORS[self.key](self.to_dict())


@dataclass(frozen=True)
class BaseConfig(Section):
    """The optimiser: batch, steps, learning rate and its schedule, weight
    decay, seed, gradient clip."""

    key: ClassVar[str] = "base"
    batch_size: int
    n_steps: int
    base_lr: float
    weight_decay: float
    seed: int
    grad_clip_norm: float | None = None
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    lr_final_fraction: float = 0.0


@dataclass(frozen=True)
class ModelConfig(Section):
    """The flow model: widths, depth, family and its sizing options."""

    key: ClassVar[str] = "model"
    noise_dimension: int
    condition_dimension: int
    latent_dimension: int
    num_blocks: int
    architecture: str | None = None
    architecture_options: dict | None = None


@dataclass(frozen=True)
class DatasetConfig(Section):
    """The data source and its tokenization."""

    key: ClassVar[str] = "dataset"
    dataset: str | None = None
    data_dir: str | None = None
    tokenization_strategy: str | None = None
    tokenization_config: dict | None = None
    resample_audio: bool = False


@dataclass(frozen=True)
class MethodConfig(Section):
    """The objective, its noise schedule, time sampling and latent QAT."""

    key: ClassVar[str] = "method"
    method: str | None = None
    use_improved_mean_flow: bool = False
    gamma: float | None = None
    flow_ratio: float | None = None
    c: float | None = None
    use_stop_gradient: bool | None = None
    loss_weighting: str | None = None
    loss_strategy: str | None = None
    noise_schedule: str | None = None
    noise_min: float | None = None
    noise_max: float | None = None
    time_sampling: str | None = None
    time_sampling_mean: float | None = None
    time_sampling_std: float | None = None
    time_sampling_data_proportion: float | None = None
    time_sampling_full_proportion: float | None = None
    use_weighted_loss: bool | None = None
    qat_mode: str | None = None
    qat_step_frac: float | None = None
    qat_bits: int | None = None


@dataclass(frozen=True)
class TrainingConfig(Section):
    """The run: sampling, workdir, checkpoints, EMA."""

    key: ClassVar[str] = "training"
    sample_every: int
    sample_seed: int
    sample_steps: int
    workdir: Path | None = None
    checkpoint_step: int | None = None
    max_checkpoints_to_keep: int | None = None
    checkpoint_format: str | None = None
    ema_decay: float | None = None
    sample_guidance_scale: float | None = None

    def __post_init__(self) -> None:
        if isinstance(self.workdir, str):
            object.__setattr__(self, "workdir", Path(self.workdir))


@dataclass(frozen=True)
class TPUConfig(Section):
    """The execution policy: mesh axes, precision, remat, donation, steps
    per call, the non-finite guard (named for the JAX package's TPU; the
    port reads it on the card)."""

    key: ClassVar[str] = "tpu"
    mesh_data: int = -1
    mesh_model: int = 1
    precision: str = "mixed"
    remat: bool = False
    donate: bool = True
    steps_per_call: int = 1
    skip_nonfinite_updates: bool = False


def MNISTConfig(**kwargs) -> DatasetConfig:
    """The MNIST dataset section (reshape tokenization unless given)."""
    kwargs.setdefault("tokenization_strategy", "reshape")
    kwargs["dataset"] = "mnist"
    return DatasetConfig(**kwargs)


def AudioConfig(**kwargs) -> DatasetConfig:
    """The audio dataset section (MDCT tokenization unless given)."""
    kwargs.setdefault("tokenization_strategy", "mdct")
    kwargs["dataset"] = "audio"
    return DatasetConfig(**kwargs)


#: section name -> its type, in the v2 dict's order
_SECTION_TYPES: dict[str, type[Section]] = {
    t.key: t for t in (BaseConfig, ModelConfig, DatasetConfig, MethodConfig,
                       TrainingConfig, TPUConfig)}
#: a field without a default (the section's required fields)
_REQUIRED = object()
#: section -> field -> default, in the sections' order
_FIELDS: dict[str, dict[str, Any]] = {
    name: {f.name: _REQUIRED if f.default is MISSING else f.default
           for f in fields(t)}
    for name, t in _SECTION_TYPES.items()}
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

    @property
    def donate(self) -> bool:
        """``tpu.donate`` (JAX's buffer donation; PyTorch updates in place
        and does not read it)."""
        return bool((self.source.get("tpu") or {}).get("donate", True))

    @property
    def config_version(self) -> str:
        return self.source.get("config_version", "2.0")

    # ---- section views (the JAX package's TrainFlowConfig) -----------------
    def _section(self, name: str) -> Section:
        return _SECTION_TYPES[name](**self._section_dict(name))

    @property
    def base(self) -> BaseConfig:
        return self._section("base")

    @property
    def model(self) -> ModelConfig:
        return self._section("model")

    @property
    def dataset_config(self) -> DatasetConfig:
        return self._section("dataset")

    @property
    def method_config(self) -> MethodConfig:
        return self._section("method")

    @property
    def training(self) -> TrainingConfig:
        return self._section("training")

    @property
    def tpu(self) -> TPUConfig:
        return self._section("tpu")

    def validate(self) -> None:
        """Raise ``ValueError`` on a value the JAX package rejects (every
        config is validated when it is made; this checks again)."""
        validate(self.to_dict())

    @classmethod
    def from_dict(cls, data: dict) -> CodecConfig:
        """:func:`config_from_dict` (the JAX package's
        ``TrainFlowConfig.from_dict``)."""
        return config_from_dict(data)

    def get_schema(self) -> dict:
        """Each section's fields: type, whether required, default, allowed
        values."""
        return {"config_version": self.config_version,
                **{name: self._section(name).get_schema()
                   for name in _SECTION_TYPES}}

    def get_documentation(self) -> str:
        """The schema as markdown, as the JAX package writes it."""
        lines = ["# TrainFlowConfig Documentation", "",
                 f"Config Version: {self.config_version}", ""]
        for name, section_type in _SECTION_TYPES.items():
            lines += [f"## {section_type.__name__}", ""]
            for field_name, info in self._section(name).get_schema().items():
                lines.append(f"- `{field_name}`: {info['type']}")
                if info.get("allowed_values"):
                    lines.append("  - Allowed values: "
                                 f"{', '.join(info['allowed_values'])}")
                if info["default"] is not None:
                    lines.append(f"  - Default: {info['default']}")
                lines.append("")
        return "\n".join(lines)

    def _section_dict(self, section: str) -> dict:
        """One section of :meth:`to_dict`: the source's section with every
        field the port reads written over it (unset fields left out)."""
        target = copy.deepcopy(self.source.get(section) or {})
        for name in _FIELDS[section]:
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
        return target

    def to_dict(self) -> dict:
        """The v2 hierarchical dict of this config: the source dict with every
        field the port reads written over it (unset fields left out)."""
        out = {key: (self._section_dict(key) if key in _FIELDS
                     else copy.deepcopy(value))
               for key, value in self.source.items()}
        out.setdefault("config_version", "2.0")
        for section in _FIELDS:
            if section not in out:
                out[section] = self._section_dict(section)
        return out


_flat_init = CodecConfig.__init__


def _sectioned_dict(base: BaseConfig, model: ModelConfig,
                    dataset: DatasetConfig, method: MethodConfig,
                    training: TrainingConfig, tpu: TPUConfig | None = None,
                    output_dir: Path | str | None = None,
                    run_name: str | None = None,
                    config_version: str = "2.0") -> dict:
    """The v2 dict of the JAX package's ``TrainFlowConfig(...)`` arguments."""
    data: dict[str, Any] = {"config_version": config_version}
    for name, section in zip(_SECTION_TYPES, (base, model, dataset, method,
                                              training, tpu or TPUConfig())):
        data[name] = section.to_dict()
    if output_dir is not None:
        data["output_dir"] = str(output_dir)
    if run_name is not None:
        data["run_name"] = run_name
    return data


def _init(self, *args, **kwargs) -> None:
    """The flat fields (as ``dataclasses.replace`` passes them), or the JAX
    package's sections: ``TrainFlowConfig(base, model, dataset, method,
    training, tpu=None, output_dir=None, run_name=None)``."""
    if "base" in kwargs or (args and isinstance(args[0], BaseConfig)):
        # validated once, by __post_init__
        normalized = _normalize(_sectioned_dict(*args, **kwargs))
        _flat_init(self, **_flat_values(normalized), source=normalized)
    else:
        _flat_init(self, *args, **kwargs)


CodecConfig.__init__ = _init
#: the JAX package's name for the sectioned config: the same type
TrainFlowConfig = CodecConfig


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


def _flat_values(normalized: dict) -> dict:
    """The flat fields of a normalised v2 dict."""
    values = {name: normalized[section][name]
              for section, names in _FIELDS.items() for name in names
              if name not in _NOT_READ and name in normalized[section]}
    missing = [name for name in list(_FIELDS["model"])[:4]
               if name not in values]
    if missing:
        raise ValueError(f"the model section needs {missing}")
    for name in _DICT_FIELDS:
        values[name] = dict(values.get(name) or {})
    return values


def config_from_dict(data: dict) -> CodecConfig:
    """Build a :class:`CodecConfig` from a parsed v1 or v2 config dict."""
    normalized = _normalize(data)
    validate(normalized)
    return CodecConfig(**_flat_values(normalized), source=normalized)


def load_config(path: Path | str) -> CodecConfig:
    """Read a v1 or v2 JSON config file."""
    with Path(path).open("r", encoding="utf-8") as f:
        return config_from_dict(json.load(f))


#: the JAX package's name for :func:`load_config`
load_config_from_json = load_config


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


def merge_configs(base: CodecConfig, override: dict) -> CodecConfig:
    """``base`` with an override dict deep-merged into its v2 dict: a
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
    return config_from_dict(_deep_merge(base.to_dict(), override))


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


def print_config_diff(diff: dict) -> None:
    """Print a :func:`diff_configs` result as the JAX package does."""
    if diff["changed"]:
        print("Changed parameters:")
        for key, change in diff["changed"].items():
            print(f"  {key}: {change['old']} -> {change['new']}")
    if diff["added"]:
        print(f"Added parameters: {', '.join(diff['added'])}")
    if diff["removed"]:
        print(f"Removed parameters: {', '.join(diff['removed'])}")
    if not (diff["changed"] or diff["added"] or diff["removed"]):
        print("No differences found.")


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
