"""The train step; counterpart of ``make_train_step`` in
``meanflow_audio_codec_tpu/training/train_step.py``.

One step: tokenize and flatten (forward only: no gradient flows through the
MDCT) -> the objective's loss -> gradients -> the raw global gradient norm
-> clip, AdamW and EMA -> the non-finite guard. PyTorch runs it eagerly;
the state is updated in place only when the guard passes.

    state = TrainState(model, make_optimizer(config), config.ema_decay)
    # on the card; TrainState(..., device="cpu") for the plain versions
    step = make_train_step(create_loss_strategy(config), adapter,
                           skip_nonfinite=config.skip_nonfinite_updates)
    state, metrics = step(state, audio, generator=gen)
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from meanflow_audio_codec_torch.training.objectives import (
    ImprovedMeanFlowObjective,
)
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    Update,
    global_norm,
)


def _all_finite(loss: torch.Tensor, grad_norm: torch.Tensor,
                update: Update) -> bool:
    """Loss, gradient norm AND every updated parameter finite: a finite but
    huge gradient can pass the first two and still overflow Adam's second
    moment into a NaN parameter."""
    checks = [torch.isfinite(loss), torch.isfinite(grad_norm)]
    checks += [torch.isfinite(p).all() for p in update.params]
    return bool(torch.stack(checks).all())


def make_train_step(objective: ImprovedMeanFlowObjective,
                    tokenizer=None, flatten: bool = True,
                    skip_nonfinite: bool = False) -> Callable:
    """Build ``step(state, batch, generator=None, noise=None, t=None,
    r=None) -> (state, metrics)``.

    ``tokenizer`` (a ``TokenAdapter``) turns raw audio into flat examples;
    ``flatten`` reshapes examples of more than one axis to one row each.
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
        for label, tensor in (("batch", batch), ("noise", noise), ("t", t),
                              ("r", r)):
            if tensor is not None and tensor.device != state.device:
                raise ValueError(f"{label} is on {tensor.device}, the train "
                                 f"state on {state.device}")
        x = batch
        with torch.no_grad():
            if tokenizer is not None:
                x = tokenizer.tokenize(x)
            if flatten and x.ndim > 2:
                x = x.reshape(x.shape[0], -1)
        loss, aux = objective.loss(state.model, x, generator=generator,
                                   noise=noise, t=t, r=r)
        grads = torch.autograd.grad(loss, state.params)
        grad_norm = global_norm(grads)
        update = state.apply_gradients(grads, grad_norm)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, **aux}
        ok = True
        if skip_nonfinite:
            ok = _all_finite(loss.detach(), grad_norm, update)
            metrics["update_ok"] = ok
        if ok:
            state.commit(update)
        return state, metrics

    return step
