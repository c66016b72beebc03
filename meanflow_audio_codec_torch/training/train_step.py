"""The train step and the chunk of K steps; counterparts of ``make_train_step``
and ``make_multi_step`` in ``meanflow_audio_codec_tpu/training/train_step.py``,
with its loss-strategy step ``train_step`` and its validation step
``make_eval_step``.

One step: tokenize and flatten (forward only: no gradient flows through the
MDCT) -> the objective's draws -> its loss (recomputed in the backward pass
with ``remat``, as the JAX package's ``jax.checkpoint`` of the loss for
``tpu.remat``; the draws are made before it, so the recomputation sees the
same ones) -> gradients -> the raw global gradient norm
-> clip, AdamW and EMA -> the non-finite guard. PyTorch runs it eagerly.
Traced (``tracing``), a chunk is the span ``train.chunk`` over one ``step``
span a step over ``step.tokenize``, ``step.draws``, ``step.forward``,
``step.backward`` and ``step.update``, and no deeper: a span costs the
host a few event records, and the step's host barely keeps ahead of the
card, so the model's products are traced in codec calls only.
The single step decides the guard on the host and updates the state in
place only when it passes; the chunk decides it on the device for each of
its K steps, so the K steps run without a host synchronisation.

A state placed on a mesh (``parallel.shard_state``) takes this rank's
slice of the batch: the draws are made for the global batch and sliced,
the gradient and the metrics are averaged over the data ranks before the
norm, and the guard decides the same way on every rank (the state's
``reduce_gradients``, ``mean_over_data`` and ``agree``).

    state = TrainState(model, make_optimizer(config), config.ema_decay)
    # on the card; TrainState(..., device="cpu") for the plain versions
    step = make_train_step(create_loss_strategy(config), adapter,
                           skip_nonfinite=config.skip_nonfinite_updates)
    state, metrics = step(state, audio, generator=gen)
    chunk = make_multi_step(create_loss_strategy(config), 16, adapter,
                            skip_nonfinite=config.skip_nonfinite_updates)
    state, series = chunk(state, audio_chunk, generator=gen)  # [16, B, T, C]
    state, loss = train_step(state, gen, adapter.tokenize(audio),
                             create_loss_strategy(config))
    evaluate = make_eval_step(create_loss_strategy(config), adapter)
    metrics = evaluate(state, gen, audio)  # {"loss": ..., "mse": ...}
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from meanflow_audio_codec_torch import tracing
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


def _step(objective, tokenizer, flatten, remat, state, batch, generator,
          given, skip_nonfinite, guard_on_host) -> dict:
    """One step on ``batch``, committed to ``state``; returns its metrics.

    With ``skip_nonfinite`` the guard decides on the host
    (``guard_on_host``: the update is committed only when it passes) or
    on the device (``commit_where``)."""
    with tracing.span("step.tokenize"), torch.no_grad():
        x = batch
        if tokenizer is not None:
            x = tokenizer.tokenize(x)
        if flatten and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
    tracing.rows(x)
    (loss, aux), grads = objective.compute_loss(
        state, generator, x, remat=remat, has_aux=True, **given)
    with tracing.span("step.update"):
        # averaged over the data ranks before the norm, the clip and AdamW
        grads = state.reduce_gradients(grads)
        grad_norm = global_norm(grads)
        update = state.apply_gradients(grads, grad_norm)
        metrics = state.mean_over_data({"loss": loss, **aux})
        metrics = {"loss": metrics.pop("loss"), "grad_norm": grad_norm,
                   **metrics}
        if not skip_nonfinite:
            state.commit(update)
            return metrics
        ok = state.agree(_finite(metrics["loss"], grad_norm, update))
        if guard_on_host:
            ok = bool(ok)
            if ok:
                state.commit(update)
        else:
            state.commit_where(update, ok)
        metrics["update_ok"] = ok
    return metrics


def make_train_step(objective: Objective, tokenizer=None,
                    flatten: bool = True, remat: bool = False,
                    skip_nonfinite: bool = False) -> Callable:
    """Build ``step(state, batch, generator=None, **given) -> (state,
    metrics)``.

    ``tokenizer`` (a ``TokenAdapter``) turns raw audio into flat examples;
    ``flatten`` reshapes examples of more than one axis to one row each;
    ``remat`` recomputes the loss in the backward pass.
    ``given`` draws (``noise``, ``t``, ``r``, ``qat_noise``) go to the
    objective; the others are drawn from ``generator``. With
    ``skip_nonfinite`` an update whose loss, gradient norm or new
    parameters are not finite is dropped and the whole state kept;
    ``metrics["update_ok"]`` says which happened. The batch and the given
    draws must lie on the state's device.
    """

    def step(state: TrainState, batch: torch.Tensor,
             generator: torch.Generator | None = None, **given):
        _check_devices(state, batch=batch, **given)
        with tracing.root("train.chunk", state.device, depth=2), \
                tracing.span("step", 0):
            metrics = _step(objective, tokenizer, flatten, remat, state,
                            batch, generator, given, skip_nonfinite, True)
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
        with tracing.root("train.chunk", state.device, depth=2):
            for i in range(num_steps):
                given = {name: d[i] for name, d in
                         (("noise", noise), ("t", t), ("r", r))
                         if d is not None}
                with tracing.span("step", i):
                    series.append(_step(objective, tokenizer, flatten, remat,
                                        state, batches[i], generator, given,
                                        skip_nonfinite, False))
            return state, {name: torch.stack([m[name] for m in series])
                           for name in series[0]}

    return run


def train_step(state: TrainState, generator: torch.Generator | None,
               x: torch.Tensor, loss_strategy: Objective, **given
               ) -> tuple[TrainState, torch.Tensor]:
    """One step through the reference's loss-strategy API, the JAX
    package's ``train_step(state, key, x, loss_strategy)`` on flat examples
    ``x``: ``make_train_step(loss_strategy, flatten=False)``'s step, whose
    gradients come from ``loss_strategy.compute_loss``, with no tokenizer,
    no remat and no non-finite guard. Returns ``(state, loss)``."""
    state, metrics = make_train_step(loss_strategy, flatten=False)(
        state, x, generator, **given)
    return state, metrics["loss"]


def make_eval_step(objective: Objective, tokenizer=None,
                   flatten: bool = True) -> Callable:
    """Build the loss-only validation step ``step(state, generator, batch,
    **given) -> {"loss": ..., **aux}`` (the JAX package's ``make_eval_step``,
    whose step takes ``(state, key, batch)``).

    Under ``torch.no_grad()``: ``tokenizer`` (``MDCTTokenization``, whose
    transform is the MDCT kernel on the card, ``ReshapeTokenization`` or a
    ``TokenAdapter``) turns the batch into tokens, ``flatten`` reshapes
    examples of more than one axis to one row each, and the objective's
    loss is taken with draws from ``generator`` (or ``given``). Nothing of
    the state changes; the metrics stay on the state's device."""

    def step(state: TrainState, generator: torch.Generator | None,
             batch: torch.Tensor, **given) -> dict:
        _check_devices(state, batch=batch, **given)
        with torch.no_grad():
            x = batch
            if tokenizer is not None:
                x = tokenizer.tokenize(x)
            if flatten and x.ndim > 2:
                x = x.reshape(x.shape[0], -1)
            loss, aux = objective.loss(
                state.model, x,
                **objective.draws_for(state, x, generator, **given))
        return {"loss": loss, **aux}

    return step
