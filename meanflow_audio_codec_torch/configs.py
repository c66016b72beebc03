"""Reader of the v2 hierarchical JSON config, limited to the fields the port uses.

Counterpart of ``meanflow_audio_codec_tpu/configs/config.py``, which
validates and migrates every field. The port reads what the codec round trip
needs (``model.*`` with ``architecture_options``, ``dataset.dataset``,
``dataset.tokenization_strategy``, ``dataset.tokenization_config``,
``tpu.precision``) and what the train step needs (the optimiser's
``base.*``, ``training.ema_decay``, the objective's ``method.*`` and
``tpu.skip_nonfinite_updates``). An absent field takes the JAX package's
default; ``None`` means "unset", and the consumer applies the default the
JAX package applies there (``training/objectives.create_loss_strategy``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

PRECISIONS = ("float32", "bfloat16", "mixed")
LR_SCHEDULES = ("constant", "cosine")
#: config section -> fields the port reads from it (beyond model/dataset)
_TRAINING_FIELDS = {
    "base": ("batch_size", "n_steps", "base_lr", "weight_decay",
             "warmup_steps", "lr_schedule", "lr_final_fraction",
             "grad_clip_norm"),
    "training": ("ema_decay",),
    "method": ("method", "use_improved_mean_flow", "loss_strategy",
               "noise_schedule", "noise_min", "noise_max", "time_sampling",
               "time_sampling_mean", "time_sampling_std",
               "time_sampling_data_proportion", "flow_ratio",
               "time_sampling_full_proportion", "use_weighted_loss",
               "use_stop_gradient", "loss_weighting", "qat_mode",
               "qat_step_frac", "qat_bits"),
    "tpu": ("skip_nonfinite_updates",),
}


@dataclass(frozen=True)
class CodecConfig:
    """The slice of a v2 config that the codec and the train step read."""

    noise_dimension: int
    condition_dimension: int
    latent_dimension: int
    num_blocks: int
    architecture: str | None = None
    architecture_options: dict = field(default_factory=dict)
    dataset: str | None = None
    tokenization_strategy: str | None = None
    tokenization_config: dict = field(default_factory=dict)
    #: compute precision; the JAX package defaults to "mixed" (bf16 compute)
    precision: str = "mixed"

    # base.*: the optimiser (the JAX package requires the first four)
    batch_size: int | None = None
    n_steps: int | None = None
    base_lr: float | None = None
    weight_decay: float | None = None
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    lr_final_fraction: float = 0.0
    grad_clip_norm: float | None = None
    # training.*
    ema_decay: float | None = None
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
    qat_mode: str | None = None
    qat_step_frac: float | None = None
    qat_bits: int | None = None
    # tpu.*: drop updates whose loss, gradient norm or parameters are not
    # finite
    skip_nonfinite_updates: bool = False

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


def config_from_dict(data: dict) -> CodecConfig:
    """Build a :class:`CodecConfig` from a parsed v2 config dict."""
    if not isinstance(data, dict) or "model" not in data:
        raise ValueError("Invalid config format: expected a v2 hierarchical "
                         "config with a 'model' section")
    model = data["model"]
    dataset = data.get("dataset") or {}
    tpu = data.get("tpu") or {}
    training = {name: (data.get(section) or {})[name]
                for section, names in _TRAINING_FIELDS.items()
                for name in names
                if (data.get(section) or {}).get(name) is not None}
    return CodecConfig(
        noise_dimension=model["noise_dimension"],
        condition_dimension=model["condition_dimension"],
        latent_dimension=model["latent_dimension"],
        num_blocks=model["num_blocks"],
        architecture=model.get("architecture"),
        architecture_options=dict(model.get("architecture_options") or {}),
        dataset=dataset.get("dataset"),
        tokenization_strategy=dataset.get("tokenization_strategy"),
        tokenization_config=dict(dataset.get("tokenization_config") or {}),
        precision=tpu.get("precision", "mixed"),
        **training,
    )


def load_config(path: Path | str) -> CodecConfig:
    """Read a v2 JSON config file."""
    with Path(path).open("r", encoding="utf-8") as f:
        return config_from_dict(json.load(f))
