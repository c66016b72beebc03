"""Noise schedules; counterpart of ``meanflow_audio_codec_tpu/ops/schedules.py``.

A schedule defines the interpolant z_t between data x0 and noise x1 and the
velocity target the model regresses.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _col(t: torch.Tensor) -> torch.Tensor:
    """Time as a column for [B, ...] data."""
    return t[:, None] if t.ndim == 1 else t


@dataclass(frozen=True)
class LinearNoiseSchedule:
    """z_t = (1-t) x0 + (noise_min + noise_max t) x1; target = noise_max x1 - x0."""

    noise_min: float = 0.001
    noise_max: float = 0.999

    def interpolate(self, x0: torch.Tensor, x1: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
        t = _col(t)
        return (1.0 - t) * x0 + (self.noise_min + self.noise_max * t) * x1

    def compute_target(self, x0: torch.Tensor, x1: torch.Tensor
                       ) -> torch.Tensor:
        return self.noise_max * x1 - x0


@dataclass(frozen=True)
class UniformNoiseSchedule:
    """Standard flow matching: z_t = (1-t) x0 + t x1; target = x1 - x0."""

    def interpolate(self, x0: torch.Tensor, x1: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
        t = _col(t)
        return (1.0 - t) * x0 + t * x1

    def compute_target(self, x0: torch.Tensor, x1: torch.Tensor
                       ) -> torch.Tensor:
        return x1 - x0


_SCHEDULES = {"linear": LinearNoiseSchedule, "uniform": UniformNoiseSchedule}


def create_noise_schedule(name: str | None, **kwargs):
    """Build a schedule by config name (None -> linear)."""
    name = name or "linear"
    if name not in _SCHEDULES:
        raise ValueError(f"Unknown noise schedule {name!r}; expected one of "
                         f"{sorted(_SCHEDULES)}")
    return _SCHEDULES[name](**kwargs)
