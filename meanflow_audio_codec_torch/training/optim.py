"""Optimiser, learning-rate schedule and train state.

Counterpart of ``make_lr_schedule``, ``lr_at_step`` and ``make_optimizer`` in
``meanflow_audio_codec_tpu/training/trainer.py`` and of ``TrainState`` in
``meanflow_audio_codec_tpu/models/train_state.py``, with optax's semantics:
``chain(clip_by_global_norm, adamw)``, the schedule read at the update count
before its increment (the first update under warmup has learning rate 0),
decoupled weight decay on every parameter.

AdamW is written here as tensor functions rather than taken from
``torch.optim`` because the train step's non-finite guard needs the whole
update out of place: new parameters, moments and EMA are computed first, as
flat tensors, and written into the model only by :meth:`TrainState.commit`,
so a step that the guard rejects leaves parameters, moments, count and EMA
as they were.
The clip also follows optax (``max_norm / norm`` when ``norm >= max_norm``;
``clip_grad_norm_`` divides by ``norm + 1e-6``).
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.device import resolve_device


def lr_schedule(config: CodecConfig, count: torch.Tensor) -> torch.Tensor:
    """The learning rate of update ``count`` (0-based, an integer tensor), in
    float64 on its device: linear warmup from 0 over ``warmup_steps``, then
    constant or cosine down to ``lr_final_fraction * base_lr`` at
    ``n_steps``."""
    base = float(config.base_lr)
    warmup = config.warmup_steps or 0
    step = count.to(torch.float64)
    lr = torch.full_like(step, base)
    if config.lr_schedule == "cosine":
        final = base * config.lr_final_fraction
        decay = max(config.n_steps - warmup, 1)
        frac = ((step - warmup) / decay).clamp(0.0, 1.0)
        lr = final + 0.5 * (base - final) * (1.0 + torch.cos(math.pi * frac))
    if warmup:
        lr = torch.where(step < warmup, base * step / warmup, lr)
    return lr


def lr_at_step(config: CodecConfig, step: int) -> float:
    """:func:`lr_schedule` at update ``step``, as a float (for the log)."""
    return float(lr_schedule(config, torch.tensor(step)))


def scheduled(config: CodecConfig) -> bool:
    """Whether the rate changes with the count (warmup or cosine), which
    decides whether optax keeps a schedule count."""
    return bool(config.warmup_steps) or config.lr_schedule == "cosine"


def make_lr_schedule(config: CodecConfig
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The schedule :func:`make_optimizer` uses, as a function of the
    count."""
    if config.base_lr is None or config.n_steps is None:
        raise ValueError("the optimiser needs base.base_lr and base.n_steps")
    return functools.partial(lr_schedule, config)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32 (a 0-d tensor).

    On the CPU each tensor's sum of squares runs in float64: torch's CPU
    float32 norm accumulates in order and drifts by about 1e-4 (relative)
    over the 4 M-element products of a 512-channel model, where the card's
    ``_foreach_norm`` stays within float32 rounding.
    """
    if tensors[0].device.type == "cpu":
        return torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(t, dtype=torch.float64)
            for t in tensors])).float()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Update(NamedTuple):
    """An update, computed out of place as flat tensors (every parameter
    tensor in the order of ``TrainState.names``, flattened and joined): new
    parameters, first and second moments, and EMA parameters (None without
    EMA)."""

    params: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    ema: torch.Tensor | None


@dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip_norm), adamw(...))``;
    ``scheduled`` says whether optax keeps a schedule count (a rate that
    changes with the count)."""

    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    weight_decay: float
    grad_clip_norm: float | None = None
    scheduled: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def update(self, params: torch.Tensor, grads: torch.Tensor,
               mu: torch.Tensor, nu: torch.Tensor, count: torch.Tensor,
               grad_norm: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(new params, new mu, new nu) for update number ``count`` (0-based,
        a 0-d integer tensor, from which the learning rate and the bias
        corrections are computed on its device); elementwise over tensors of
        one shape; ``grad_norm`` is the global norm of ``grads``."""
        b1, b2 = self.b1, self.b2
        n = count.to(torch.float64) + 1
        bc1 = (1 - torch.pow(b1, n)).to(torch.float32)
        bc2 = (1 - torch.pow(b2, n)).to(torch.float32)
        if self.grad_clip_norm:
            scale = torch.where(grad_norm < self.grad_clip_norm,
                                torch.ones_like(grad_norm),
                                self.grad_clip_norm / grad_norm)
            grads = grads * scale
        new_mu = grads * (1 - b1) + mu * b1
        new_nu = grads * grads * (1 - b2) + nu * b2
        denom = torch.sqrt(new_nu / bc2).add_(self.eps)
        upd = new_mu / bc1 / denom
        if self.weight_decay:
            upd.add_(params, alpha=self.weight_decay)
        lr = self.learning_rate(count).to(torch.float32)
        return params - upd * lr, new_mu, new_nu


def make_optimizer(config: CodecConfig) -> AdamW:
    """AdamW with the config's schedule, weight decay and optional clip."""
    if config.weight_decay is None:
        raise ValueError("the optimiser needs base.weight_decay")
    return AdamW(make_lr_schedule(config), config.weight_decay,
                 config.grad_clip_norm, scheduled(config))


def flatten(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors flattened and joined, in order, into one 1-d tensor."""
    return torch.cat([t.reshape(-1) for t in tensors])


class TrainState:
    """The model's parameters, AdamW's moments, the update count and an
    optional EMA copy of the parameters (decay ``ema_decay``; None disables
    it).

    Each of parameters, moments and EMA is one flat float32 tensor on the
    state's device, so an update is a few elementwise launches and the
    non-finite guard selects each with one ``torch.where``. The model's
    parameters are views of the flat parameter tensor; ``params``, ``mu``,
    ``nu`` and ``ema`` list the per-parameter views in the order of
    ``names``. ``count`` is the number of committed updates as a 0-d int64
    tensor on the device (optax's count): the optimiser reads its learning
    rate and bias corrections from it there, so a chunk of steps whose
    updates the device accepts or rejects (:meth:`commit_where`) runs
    without a host synchronisation; ``step`` reads it on the host.

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
        dtypes = {p.dtype for _, p in named}
        if len(dtypes) != 1:
            raise ValueError(f"TrainState needs parameters of one dtype, got "
                             f"{sorted(map(str, dtypes))}")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self._shapes = [p.shape for p in self.params]
        self._numels = [p.numel() for p in self.params]
        self.device = self.params[0].device
        with torch.no_grad():
            self._params = flatten([p.detach() for p in self.params])
            for p, view in zip(self.params, self._views(self._params)):
                p.data = view
        self._mu = torch.zeros_like(self._params)
        self._nu = torch.zeros_like(self._params)
        self.count = torch.zeros((), dtype=torch.int64, device=self.device)
        self.ema_decay = ema_decay
        self._ema = self._params.clone() if ema_decay else None

    def _views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        return [v.view(shape) for v, shape in
                zip(flat.split(self._numels), self._shapes)]

    def _flat(self, tensors: list[torch.Tensor]) -> torch.Tensor:
        return flatten(tensors).to(self._params)

    @property
    def mu(self) -> list[torch.Tensor]:
        return self._views(self._mu)

    @mu.setter
    def mu(self, tensors: list[torch.Tensor]) -> None:
        self._mu = self._flat(tensors)

    @property
    def nu(self) -> list[torch.Tensor]:
        return self._views(self._nu)

    @nu.setter
    def nu(self, tensors: list[torch.Tensor]) -> None:
        self._nu = self._flat(tensors)

    @property
    def ema(self) -> list[torch.Tensor] | None:
        return None if self._ema is None else self._views(self._ema)

    @ema.setter
    def ema(self, tensors: list[torch.Tensor]) -> None:
        if self._ema is None:
            raise ValueError("this state keeps no EMA (ema_decay unset)")
        self._ema = self._flat(tensors)

    @property
    def step(self) -> int:
        """Committed updates (reads ``count`` from the device)."""
        return int(self.count)

    @step.setter
    def step(self, value: int) -> None:
        self.count.fill_(int(value))

    def apply_gradients(self, grads: list[torch.Tensor],
                        grad_norm: torch.Tensor) -> Update:
        """The update these gradients (one per parameter) give, not yet
        written anywhere."""
        with torch.no_grad():
            params, mu, nu = self.optimizer.update(
                self._params, flatten(grads), self._mu, self._nu, self.count,
                grad_norm)
            ema = None
            if self._ema is not None:
                d = self.ema_decay
                ema = self._ema * d + params * (1.0 - d)
        return Update(params, mu, nu, ema)

    def commit(self, update: Update) -> None:
        """Write ``update`` into the model and the state; count it."""
        with torch.no_grad():
            self._params.copy_(update.params)
            self.count.add_(1)
        self._mu, self._nu, self._ema = update.mu, update.nu, update.ema

    def commit_where(self, update: Update, ok: torch.Tensor) -> None:
        """:meth:`commit` where the 0-d bool tensor ``ok`` holds, else keep
        parameters, moments, count and EMA: selected on the device, as the
        JAX package's in-graph guard selects with ``jnp.where``."""
        with torch.no_grad():
            self._params.copy_(torch.where(ok, update.params, self._params))
            self._mu = torch.where(ok, update.mu, self._mu)
            self._nu = torch.where(ok, update.nu, self._nu)
            if self._ema is not None:
                self._ema = torch.where(ok, update.ema, self._ema)
            self.count.add_(ok.to(torch.int64))

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """EMA parameters by the model's parameter names."""
        if self._ema is None:
            raise ValueError("this state keeps no EMA (ema_decay unset)")
        return dict(zip(self.names, self.ema))
