"""Loss primitives; counterpart of ``meanflow_audio_codec_tpu/ops/losses.py``.

Every reduction runs in float32 whatever the input dtype, so bf16
activations do not degrade the loss statistics.
"""

from __future__ import annotations

import torch


def _per_example_sq(delta: torch.Tensor) -> torch.Tensor:
    """Sum of squares over all non-batch axes, in float32."""
    delta = delta.float()
    return (delta * delta).sum(dim=tuple(range(1, delta.ndim)))


def weighted_l2_per_example(pred: torch.Tensor, target: torch.Tensor,
                            p: float = 1.0, c: float = 1e-3) -> torch.Tensor:
    """Adaptively weighted L2 per example: ``sg(1/(||d||^2+c)^p) * ||d||^2``."""
    per_example = _per_example_sq(pred - target)
    weights = (1.0 / (per_example + c) ** p).detach()
    return weights * per_example


def mse_per_example(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-example mean squared error, float32."""
    delta = (pred - target).float()
    return (delta * delta).mean(dim=tuple(range(1, delta.ndim)))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, float32."""
    delta = (pred - target).float()
    return (delta * delta).mean()


def time_dependent_weight(t: torch.Tensor, c: float = 1e-2) -> torch.Tensor:
    """``w(t) = 1/(t^2 + c)`` normalised to batch mean 1."""
    t = t.float().reshape(-1)
    w = 1.0 / (t * t + c)
    return w / w.mean()


def apply_loss_weighting(per_example: torch.Tensor, t: torch.Tensor,
                         weighting: str | None) -> torch.Tensor:
    """Reduce per-example terms under the configured time weighting:
    ``uniform`` (plain mean) or ``time_dependent``."""
    if weighting in (None, "uniform"):
        return per_example.mean()
    if weighting == "time_dependent":
        return (time_dependent_weight(t) * per_example).mean()
    if weighting == "learned":
        raise NotImplementedError(
            "loss_weighting='learned' is not ported yet")
    raise ValueError(f"Unknown loss_weighting: {weighting}. Must be one of: "
                     "'uniform', 'time_dependent', 'learned'")


def ema(mu, dx, beta: float = 0.99):
    """Scalar EMA for loss logging; returns ``dx`` when ``mu`` is None."""
    return beta * mu + (1.0 - beta) * dx if mu is not None else dx
