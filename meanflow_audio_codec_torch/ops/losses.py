"""Loss primitives; counterpart of ``meanflow_audio_codec_tpu/ops/losses.py``.

Every reduction runs in float32 whatever the input dtype, so bf16
activations do not degrade the loss statistics.

``loss_weighting='learned'`` trains a log-variance polynomial jointly with
the model: :func:`attach_learned_weighting` gives the model a
``loss_weighting`` submodule whose ``poly`` parameter then sits in the train
state's flat buffers like every other parameter, and in the checkpoint at
``params["loss_weighting"]["poly"]``, where the JAX package keeps it.
"""

from __future__ import annotations

import torch
from torch import nn

#: the model attribute, and the top-level key of the Flax param tree, that
#: holds the learned weighting's parameters
LEARNED_WEIGHT_KEY = "loss_weighting"


def _per_example_sq(delta: torch.Tensor) -> torch.Tensor:
    """Sum of squares over all non-batch axes, in float32."""
    delta = delta.float()
    return (delta * delta).sum(dim=tuple(range(1, delta.ndim)))


def weighted_l2_loss(pred: torch.Tensor, target: torch.Tensor,
                     p: float = 1.0, c: float = 1e-3) -> torch.Tensor:
    """Adaptively weighted L2: ``mean(sg(1/(||d||^2+c)^p) * ||d||^2)``."""
    return weighted_l2_per_example(pred, target, p, c).mean()


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


def adaptive_weighted_per_example(err: torch.Tensor, gamma: float = 0.5,
                                  c: float = 1e-3) -> torch.Tensor:
    """Mean flow's adaptive terms ``sg(1/(e+c)^(1-gamma)) * e``, with ``e``
    the per-example *mean* squared error."""
    err = err.float()
    delta_sq = (err * err).mean(dim=tuple(range(1, err.ndim)))
    w = (1.0 / (delta_sq + c) ** (1.0 - gamma)).detach()
    return w * delta_sq


def adaptive_weighted_loss(err: torch.Tensor, gamma: float = 0.5,
                           c: float = 1e-3) -> torch.Tensor:
    """Mean flow's adaptive reweighting, ``mean(sg(1/(e+c)^(1-gamma)) * e)``
    with ``e`` the per-example mean squared error."""
    return adaptive_weighted_per_example(err, gamma, c).mean()


def time_dependent_weight(t: torch.Tensor, c: float = 1e-2) -> torch.Tensor:
    """``w(t) = 1/(t^2 + c)`` normalised to batch mean 1."""
    t = t.float().reshape(-1)
    w = 1.0 / (t * t + c)
    return w / w.mean()


def init_learned_weight_params() -> dict:
    """Fresh parameters for ``loss_weighting='learned'``: ``{"poly":
    zeros(3)}`` float32, s(t) = 0 (w(t) = 1, regulariser 0). The JAX
    package merges them into its param tree under ``loss_weighting``; the
    port holds them as a module's parameter instead, which
    :func:`attach_learned_weighting` gives the model (``model.loss_weighting
    .poly``, initialised from these values)."""
    return {"poly": torch.zeros(3, dtype=torch.float32)}


class LearnedWeighting(nn.Module):
    """The log-variance polynomial ``s(t) = a0 + a1 t + a2 t^2``, zero at
    init (w(t) = 1, regulariser 0)."""

    def __init__(self):
        super().__init__()
        self.poly = nn.Parameter(init_learned_weight_params()["poly"])


def attach_learned_weighting(model: nn.Module) -> nn.Module:
    """Give ``model`` the learned weighting's parameters (the JAX trainer
    merges :func:`init_learned_weight_params` into its param tree)."""
    setattr(model, LEARNED_WEIGHT_KEY, LearnedWeighting())
    return model


def learned_weight_terms(poly: torch.Tensor, t: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kendall-style uncertainty weighting: ``(w(t), regulariser)`` with
    ``w(t) = exp(-s(t))`` and ``reg = mean(s(t))``."""
    poly = poly.float()
    t = t.float().reshape(-1)
    s = poly[0] + poly[1] * t + poly[2] * t * t
    return torch.exp(-s), s.mean()


def apply_loss_weighting(per_example: torch.Tensor, t: torch.Tensor,
                         weighting: str | None,
                         model: nn.Module | None = None) -> torch.Tensor:
    """Reduce per-example terms under the configured time weighting:
    ``uniform`` (plain mean), ``time_dependent`` or ``learned`` (the
    polynomial of ``model``'s ``loss_weighting`` submodule, see
    :func:`attach_learned_weighting`)."""
    if weighting in (None, "uniform"):
        return per_example.mean()
    if weighting == "time_dependent":
        return (time_dependent_weight(t) * per_example).mean()
    if weighting == "learned":
        learned = getattr(model, LEARNED_WEIGHT_KEY, None)
        if learned is None:
            raise ValueError(
                "loss_weighting='learned' requires learned-weight params: "
                "attach_learned_weighting(model) at init (the trainer does "
                "this)")
        w, reg = learned_weight_terms(learned.poly, t)
        return (w * per_example).mean() + reg
    raise ValueError(f"Unknown loss_weighting: {weighting}. Must be one of: "
                     "'uniform', 'time_dependent', 'learned'")


def normalized_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """``||pred - target||^2 / (||target||^2 + eps)`` per example, meaned."""
    num = _per_example_sq(pred - target)
    den = _per_example_sq(target)
    return (num / (den + eps)).mean()


def ema(mu, dx, beta: float = 0.99):
    """Scalar EMA for loss logging; returns ``dx`` when ``mu`` is None."""
    return beta * mu + (1.0 - beta) * dx if mu is not None else dx
