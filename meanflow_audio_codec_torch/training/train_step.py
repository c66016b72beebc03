"""The train step and the chunk of K steps; counterparts of ``make_train_step``
and ``make_multi_step`` in ``meanflow_audio_codec_tpu/training/train_step.py``.

One step: tokenize and flatten (forward only: no gradient flows through the
MDCT) -> the objective's draws -> its loss (recomputed in the backward pass
with ``remat``, as the JAX package's ``jax.checkpoint`` of the loss for
``tpu.remat``; the draws are made before it, so the recomputation sees the
same ones) -> gradients -> the raw global gradient norm
-> clip, AdamW and EMA -> the non-finite guard. PyTorch runs it eagerly.
The single step decides the guard on the host and updates the state in
place only when it passes; the chunk decides it on the device for each of
its K steps, so the K steps run without a host synchronisation.

    state = TrainState(model, make_optimizer(config), config.ema_decay)
    # on the card; TrainState(..., device="cpu") for the plain versions
    step = make_train_step(create_loss_strategy(config), adapter,
                           skip_nonfinite=config.skip_nonfinite_updates)
    state, metrics = step(state, audio, generator=gen)
    chunk = make_multi_step(create_loss_strategy(config), 16, adapter,
                            skip_nonfinite=config.skip_nonfinite_updates)
    state, series = chunk(state, audio_chunk, generator=gen)  # [16, B, T, C]
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch.utils.checkpoint import checkpoint

from meanflow_audio_codec_torch.training.objectives import Objective
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    Update,
    global_norm,
)


def _finite(loss: torch.Tensor, grad_norm: torch.Tensor,
            update: Update) -> torch.Tensor:
    """Loss, gradient norm AND every updated parameter finite, as a 0-d
    bool tensor: a finite but huge gradient can pass the first two and still
    overflow Adam's second moment into a NaN parameter."""
    return (torch.isfinite(loss) & torch.isfinite(grad_norm)
            & torch.isfinite(update.params).all())


def _check_devices(state: TrainState, **tensors) -> None:
    for label, tensor in tensors.items():
        if tensor is not None and tensor.device != state.device:
            raise ValueError(f"{label} is on {tensor.device}, the train "
                             f"state on {state.device}")


def _loss_and_update(objective, tokenizer, flatten, remat, state, batch,
                     generator, noise, t, r):
    """(metrics, update) of one step on ``batch``; nothing is written."""
    x = batch
    with torch.no_grad():
        if tokenizer is not None:
            x = tokenizer.tokenize(x)
        if flatten and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
    draws = objective.draw(state.model, x, generator, noise=noise, t=t, r=r)

    def loss_fn():
        return objective.loss(state.model, x, **draws)

    loss, aux = (checkpoint(loss_fn, use_reentrant=False) if remat
                 else loss_fn())
    grads = torch.autograd.grad(loss, state.params)
    grad_norm = global_norm(grads)
    update = state.apply_gradients(grads, grad_norm)
    return {"loss": loss.detach(), "grad_norm": grad_norm, **aux}, update


def make_train_step(objective: Objective, tokenizer=None,
                    flatten: bool = True, remat: bool = False,
                    skip_nonfinite: bool = False) -> Callable:
    """Build ``step(state, batch, generator=None, noise=None, t=None,
    r=None) -> (state, metrics)``.

    ``tokenizer`` (a ``TokenAdapter``) turns raw audio into flat examples;
    ``flatten`` reshapes examples of more than one axis to one row each;
    ``remat`` recomputes the loss in the backward pass.
    ``noise``, ``t`` and ``r`` go to the objective (drawn from ``generator``
    when absent). With ``skip_nonfinite`` an update whose loss, gradient
    norm or new parameters are not finite is dropped and the whole state
    kept; ``metrics["update_ok"]`` says which happened. The batch, and
    ``noise``, ``t`` and ``r`` when given, must lie on the state's device.
    """

    def step(state: TrainState, batch: torch.Tensor,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None, t: torch.Tensor | None = None,
             r: torch.Tensor | None = None):
        _check_devices(state, batch=batch, noise=noise, t=t, r=r)
        metrics, update = _loss_and_update(objective, tokenizer, flatten,
                                           remat, state, batch, generator,
                                           noise, t, r)
        ok = True
        if skip_nonfinite:
            ok = bool(_finite(metrics["loss"], metrics["grad_norm"], update))
            metrics["update_ok"] = ok
        if ok:
            state.commit(update)
        return state, metrics

    return step


def make_multi_step(objective: Objective, num_steps: int,
                    tokenizer=None, flatten: bool = True, remat: bool = False,
                    skip_nonfinite: bool = False) -> Callable:
    """Build ``run(state, batches, generator=None, noise=None, t=None,
    r=None) -> (state, metrics)``: ``num_steps`` steps over ``batches``
    ``[num_steps, B, ...]``, with no host synchronisation between them.

    ``noise``, ``t`` and ``r``, when given, are stacked per step
    (``[num_steps, ...]``). With ``skip_nonfinite`` each step's guard is a
    device tensor and the state is selected on the device (parameters,
    moments, count and EMA kept where it fails), as JAX's scan does it.
    ``metrics`` holds one stacked device tensor per name (``update_ok`` as
    bool); the caller reads them when it needs them.
    """

    def run(state: TrainState, batches: torch.Tensor,
            generator: torch.Generator | None = None,
            noise: torch.Tensor | None = None, t: torch.Tensor | None = None,
            r: torch.Tensor | None = None):
        _check_devices(state, batches=batches, noise=noise, t=t, r=r)
        if batches.shape[0] != num_steps:
            raise ValueError(f"expected {num_steps} batches, got "
                             f"{batches.shape[0]}")
        series = []
        for i in range(num_steps):
            draws = [d[i] if d is not None else None for d in (noise, t, r)]
            metrics, update = _loss_and_update(
                objective, tokenizer, flatten, remat, state, batches[i],
                generator, *draws)
            if skip_nonfinite:
                ok = _finite(metrics["loss"], metrics["grad_norm"], update)
                state.commit_where(update, ok)
                metrics["update_ok"] = ok
            else:
                state.commit(update)
            series.append(metrics)
        return state, {name: torch.stack([m[name] for m in series])
                       for name in series[0]}

    return run
