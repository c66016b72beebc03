"""Reader of the v2 hierarchical JSON config, limited to the codec's fields.

Counterpart of ``meanflow_audio_codec_tpu/configs/config.py``, which
validates and migrates every training field. The port reads only what the
codec round trip needs: ``model.*`` (with ``architecture_options``),
``dataset.dataset``, ``dataset.tokenization_strategy``,
``dataset.tokenization_config`` and ``tpu.precision``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

PRECISIONS = ("float32", "bfloat16", "mixed")


@dataclass(frozen=True)
class CodecConfig:
    """The codec-relevant slice of a v2 config."""

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


def config_from_dict(data: dict) -> CodecConfig:
    """Build a :class:`CodecConfig` from a parsed v2 config dict."""
    if not isinstance(data, dict) or "model" not in data:
        raise ValueError("Invalid config format: expected a v2 hierarchical "
                         "config with a 'model' section")
    model = data["model"]
    dataset = data.get("dataset") or {}
    tpu = data.get("tpu") or {}
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
    )


def load_config(path: Path | str) -> CodecConfig:
    """Read a v2 JSON config file."""
    with Path(path).open("r", encoding="utf-8") as f:
        return config_from_dict(json.load(f))
