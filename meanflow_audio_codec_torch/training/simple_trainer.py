"""Minimal standalone trainer; counterpart of
``meanflow_audio_codec_tpu/training/simple_trainer.py``.

Self-contained flow-matching and improved-mean-flow steps with the
normalized-MSE loss, a ``create_train_state`` that initialises every
parameter, and an epoch loop, for notebooks and quick experiments without
the full trainer. Noise, ``t`` and ``r`` are drawn from a
``torch.Generator`` on the state's device, or passed in (tests pass the JAX
step's draws).

    state = create_train_state(model, torch.Generator().manual_seed(0), 16)
    state, loss = train_step_flow_matching(state, generator, x)
    state, mean_loss = train_epoch(state, generator, batches)
"""

from __future__ import annotations

import functools
from typing import Iterable

import torch
from torch import nn

from meanflow_audio_codec_torch.models.factories import init_weights
from meanflow_audio_codec_torch.ops.losses import normalized_mse_loss
from meanflow_audio_codec_torch.ops.time_sampling import logit_normal, sample_tr
from meanflow_audio_codec_torch.training.objectives import _jvp, _time_pair
from meanflow_audio_codec_torch.training.optim import (
    AdamW,
    TrainState,
    global_norm,
)


def _constant_rate(rate: float, count: torch.Tensor) -> torch.Tensor:
    return torch.full((), rate, dtype=torch.float64, device=count.device)


def create_train_state(model: nn.Module,
                       generator: torch.Generator | None,
                       batch_size: int, learning_rate: float = 1e-4,
                       weight_decay: float = 1e-4,
                       device: str | torch.device = "cuda") -> TrainState:
    """Initialise every parameter (encoder and decoder; Flax's default init
    from ``generator``, a CPU generator) and wrap them with optax's
    ``adamw(learning_rate, weight_decay=weight_decay)`` on ``device``.
    ``batch_size`` is accepted and unused, as the shapes are the model's."""
    del batch_size
    init_weights(model, generator)
    optimizer = AdamW(functools.partial(_constant_rate, learning_rate),
                      weight_decay)
    return TrainState(model, optimizer, None, device=device)


def _apply(state: TrainState, loss: torch.Tensor) -> TrainState:
    grads = torch.autograd.grad(loss, state.params)
    state.commit(state.apply_gradients(grads, global_norm(grads)))
    return state


def _noise(x: torch.Tensor, generator, noise):
    return noise if noise is not None else torch.randn(
        x.shape, generator=generator, dtype=x.dtype, device=x.device)


def train_step_flow_matching(state: TrainState,
                             generator: torch.Generator | None,
                             x: torch.Tensor, noise: torch.Tensor | None = None,
                             t: torch.Tensor | None = None
                             ) -> tuple[TrainState, torch.Tensor]:
    """One FM step with the normalized MSE; returns (state, loss)."""
    noise = _noise(x, generator, noise)
    if t is None:
        t = logit_normal((x.shape[0], 1), generator, dtype=x.dtype,
                         device=x.device)
    noised = (1.0 - t) * x + t * noise
    target = noise - x
    model = state.model
    pred = model(noised, _time_pair(t), model.encode(x))
    loss = normalized_mse_loss(pred, target)
    return _apply(state, loss), loss.detach()


def train_step_improved_mean_flow(state: TrainState,
                                  generator: torch.Generator | None,
                                  x: torch.Tensor,
                                  noise: torch.Tensor | None = None,
                                  t: torch.Tensor | None = None,
                                  r: torch.Tensor | None = None
                                  ) -> tuple[TrainState, torch.Tensor]:
    """One iMF step with the normalized MSE: the boundary velocity v, then
    (u, du/dt) along (v, 1, 0) and ``u + (t - r) sg(du/dt)``; returns
    (state, loss)."""
    noise = _noise(x, generator, noise)
    if (t is None) != (r is None):
        raise ValueError("pass both t and r, or neither")
    if t is None:
        t, r = sample_tr(x.shape[0], generator, dtype=x.dtype,
                         device=x.device)
    noised = (1.0 - t) * x + t * noise
    target = noise - x
    model = state.model
    latents = model.encode(x)
    # du/dt is detached, so no gradient reaches v through the tangent
    with torch.no_grad():
        v = model(noised, _time_pair(t), latents)
    u, dudt = _jvp(model, noised, v, t, r, latents, False)
    loss = normalized_mse_loss(u + (t - r) * dudt, target)
    return _apply(state, loss), loss.detach()


def train_epoch(state: TrainState, generator: torch.Generator | None,
                batches: Iterable, use_improved_mean_flow: bool = False
                ) -> tuple[TrainState, float]:
    """Drive one epoch over ``batches`` (arrays or tensors); returns
    (state, mean loss)."""
    step_fn = (train_step_improved_mean_flow if use_improved_mean_flow
               else train_step_flow_matching)
    total, count = 0.0, 0
    for batch in batches:
        x = torch.as_tensor(batch, dtype=torch.float32, device=state.device)
        state, loss = step_fn(state, generator, x)
        total += float(loss)
        count += 1
    return state, (total / count if count else float("nan"))
