"""Optimiser, learning-rate schedule and train state.

Counterpart of ``make_lr_schedule``, ``lr_at_step`` and ``make_optimizer`` in
``meanflow_audio_codec_tpu/training/trainer.py`` and of ``TrainState`` in
``meanflow_audio_codec_tpu/models/train_state.py``, with optax's semantics:
``chain(clip_by_global_norm, adamw)``, the schedule read at the update count
before its increment (the first update under warmup has learning rate 0),
decoupled weight decay on every parameter.

AdamW is written here as tensor functions rather than taken from
``torch.optim`` because the train step's non-finite guard needs the whole
update out of place: new parameters, moments and EMA are computed first and
written into the model only by :meth:`TrainState.commit`, so a step that
the guard rejects leaves parameters, moments, count and EMA as they were.
The clip also follows optax (``max_norm / norm`` when ``norm >= max_norm``;
``clip_grad_norm_`` divides by ``norm + 1e-6``).
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.device import resolve_device


def lr_at_step(config: CodecConfig, step: int) -> float:
    """The learning rate of update ``step`` (0-based): linear warmup from 0
    over ``warmup_steps``, then constant or cosine down to
    ``lr_final_fraction * base_lr`` at ``n_steps``."""
    base = float(config.base_lr)
    warmup = config.warmup_steps or 0
    if warmup and step < warmup:
        return base * step / warmup
    if config.lr_schedule == "cosine":
        final = base * config.lr_final_fraction
        decay = max(config.n_steps - warmup, 1)
        frac = min(max((step - warmup) / decay, 0.0), 1.0)
        return final + 0.5 * (base - final) * (1.0 + math.cos(math.pi * frac))
    return base


def make_lr_schedule(config: CodecConfig) -> Callable[[int], float]:
    """The schedule :func:`make_optimizer` uses, as a function of the count."""
    if config.base_lr is None or config.n_steps is None:
        raise ValueError("the optimiser needs base.base_lr and base.n_steps")
    return lambda step: lr_at_step(config, step)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32 (a 0-d tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Update(NamedTuple):
    """An update, computed out of place: new parameters, first and second
    moments, and EMA parameters (None without EMA)."""

    params: list[torch.Tensor]
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    ema: list[torch.Tensor] | None


@dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip_norm), adamw(...))``."""

    learning_rate: Callable[[int], float]
    weight_decay: float
    grad_clip_norm: float | None = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               mu: list[torch.Tensor], nu: list[torch.Tensor], count: int,
               grad_norm: torch.Tensor
               ) -> tuple[list[torch.Tensor], list[torch.Tensor],
                          list[torch.Tensor]]:
        """(new params, new mu, new nu) for update number ``count``
        (0-based); ``grad_norm`` is the global norm of ``grads``."""
        if self.grad_clip_norm:
            scale = torch.where(grad_norm < self.grad_clip_norm,
                                torch.ones_like(grad_norm),
                                self.grad_clip_norm / grad_norm)
            grads = torch._foreach_mul(grads, scale)
        b1, b2 = self.b1, self.b2
        new_mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                    torch._foreach_mul(mu, b1))
        new_nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(nu, b2))
        denom = torch._foreach_sqrt(
            torch._foreach_div(new_nu, 1 - b2 ** (count + 1)))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(
            torch._foreach_div(new_mu, 1 - b1 ** (count + 1)), denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        new_params = torch._foreach_add(params, upd,
                                        alpha=-self.learning_rate(count))
        return new_params, new_mu, new_nu


def make_optimizer(config: CodecConfig) -> AdamW:
    """AdamW with the config's schedule, weight decay and optional clip."""
    if config.weight_decay is None:
        raise ValueError("the optimiser needs base.weight_decay")
    return AdamW(make_lr_schedule(config), config.weight_decay,
                 config.grad_clip_norm)


class TrainState:
    """The model's parameters, AdamW's moments, the update count and an
    optional EMA copy of the parameters (decay ``ema_decay``; None disables
    it). ``step`` counts committed updates, as optax's count does.

    The model is moved to ``device``, which defaults to ``"cuda"`` and
    raises when no card is present; pass ``device="cpu"`` to train through
    the plain PyTorch versions of the kernels.
    """

    def __init__(self, model: nn.Module, optimizer: AdamW,
                 ema_decay: float | None = None,
                 device: str | torch.device = "cuda"):
        self.model = model.to(resolve_device(device))
        self.optimizer = optimizer
        named = list(self.model.named_parameters())
        if not named:
            raise ValueError("TrainState needs a model with parameters")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.device = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step = 0
        self.ema_decay = ema_decay
        self.ema = ([p.detach().clone() for p in self.params]
                    if ema_decay else None)

    def apply_gradients(self, grads: list[torch.Tensor],
                        grad_norm: torch.Tensor) -> Update:
        """The update these gradients give, not yet written anywhere."""
        with torch.no_grad():
            params, mu, nu = self.optimizer.update(
                [p.detach() for p in self.params], list(grads), self.mu,
                self.nu, self.step, grad_norm)
            ema = None
            if self.ema is not None:
                d = self.ema_decay
                ema = torch._foreach_add(torch._foreach_mul(self.ema, d),
                                         torch._foreach_mul(params, 1.0 - d))
        return Update(params, mu, nu, ema)

    def commit(self, update: Update) -> None:
        """Write ``update`` into the model and the state; count it."""
        with torch.no_grad():
            torch._foreach_copy_(self.params, update.params)
        self.mu, self.nu, self.ema = update.mu, update.nu, update.ema
        self.step += 1

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """EMA parameters by the model's parameter names."""
        if self.ema is None:
            raise ValueError("this state keeps no EMA (ema_decay unset)")
        return dict(zip(self.names, self.ema))
