"""Training objectives: autoencoder, flow matching, mean flow, improved mean
flow; counterpart of ``meanflow_audio_codec_tpu/training/objectives.py``.

  FM  : z = interp(x, e, t);  v̂ = f(z, [t,0], lat);  L = w‖v̂ - tgt‖²
  MF  : z = (1-t)x + te (the uniform interpolant, by definition);
        (u, du/dt) = jvp(f, (z,t,r), (e-x, 1, 0));
        u_tgt = (e-x) - clip(t-r)·sg(du/dt);
        L = mean(sg(1/(mse+c)^(1-γ)) · mse(u - u_tgt))
  iMF : v = f(z, [t,0], lat)          (boundary: u(z,t,t) = v(z,t))
        (u, du/dt) = jvp(f, (z,t,r), (v, 1, 0));
        v_pred = u + (t-r)·sg(du/dt);  L = w‖v_pred - tgt‖²
  AE  : lat = encode(x); x̂ = f(0, [0,0], lat);  L = ‖x̂ - x‖²

The JVP is PyTorch's forward-mode AD (``torch.autograd.forward_ad``): z gets
the tangent and t the tangent 1, so h = t - r gets tangent 1 from the
autodiff itself. With the stop-gradient (the default) the dual forward runs
off the autograd tape and u comes from a plain forward (``_jvp``), so no
tangent is held for the backward, as in JAX. With
``use_stop_gradient=False`` the gradient also flows
through du/dt (reverse mode over the forward mode): the iMF boundary forward
then keeps its graph, and the fused stage ops record their tangent rules
(``ops.stage.differentiable_tangents``). The model signature is
``model(z, time, latents)`` with ``time = [t, h]`` columns, and
``model.encode(x)``.

Every objective's random inputs (``noise``, ``t``, ``r``, and the latent QAT
noise ``qat_noise``) are drawn by :meth:`Objective.draw` from a
``torch.Generator``, or passed in (tests pass what the JAX loss drew), so a
caller can draw them before a checkpointed loss that recomputes itself.
:meth:`Objective.compute_loss` is the JAX package's loss-strategy API,
``(loss, grads)`` for a train state; ``FlowMatchingLoss``, ``MeanFlowLoss``,
``ImprovedMeanFlowLoss`` and ``LossStrategy`` are its aliases.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn
from torch.utils.checkpoint import checkpoint

from meanflow_audio_codec_torch import tracing
from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.ops import stage
from meanflow_audio_codec_torch.ops.latent_quant import LatentQAT
from meanflow_audio_codec_torch.ops.losses import (
    adaptive_weighted_per_example,
    apply_loss_weighting,
    mse_loss,
    mse_per_example,
    weighted_l2_loss,
    weighted_l2_per_example,
)
from meanflow_audio_codec_torch.ops.schedules import (
    LinearNoiseSchedule,
    create_noise_schedule,
)
from meanflow_audio_codec_torch.ops.time_sampling import (
    LogitNormalTimeSampling,
    MeanFlowTimeSampling,
    UniformTimeSampling,
)

Losses = tuple[torch.Tensor, dict[str, torch.Tensor]]


def _time_pair(t: torch.Tensor, h: torch.Tensor | None = None) -> torch.Tensor:
    """Stack (t, h) columns; h defaults to 0 (instantaneous velocity)."""
    if h is None:
        h = torch.zeros_like(t)
    return torch.cat([t, h], dim=-1)


class Objective:
    """Base: the draws, the QAT hook and ``loss``.

    ``_times`` is how many time columns the objective draws (0, 1 for t, 2
    for the ordered pair (t, r)); ``_noise`` whether it draws noise.
    """

    _noise = True
    _times = 0
    latent_qat: LatentQAT | None = None

    def draw(self, model: nn.Module, x: torch.Tensor,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None, t: torch.Tensor | None = None,
             r: torch.Tensor | None = None,
             qat_noise: torch.Tensor | None = None) -> dict:
        """The random inputs of :meth:`loss` on ``x`` [B, D]: those given,
        the rest drawn from ``generator`` (noise, then times, then the QAT
        noise)."""
        batch, out = x.shape[0], {}
        if self._noise:
            out["noise"] = (noise if noise is not None else torch.randn(
                x.shape, generator=generator, dtype=x.dtype, device=x.device))
        if self._times == 1:
            out["t"] = (t if t is not None else self.time_sampling.sample_time(
                batch, generator, dtype=x.dtype, device=x.device))
        elif self._times == 2:
            if (t is None) != (r is None):
                raise ValueError("pass both t and r, or neither")
            if t is None:
                t, r = self.time_sampling.sample_time_pair(
                    batch, generator, dtype=x.dtype, device=x.device)
            out["t"], out["r"] = t, r
        qat = self.latent_qat
        if qat is not None and qat.mode == "noise":
            # the shape of encode's output, which the quantizer sees:
            # [B, latent] or the mixer's [B, tokens, latent]
            out["qat_noise"] = (qat_noise if qat_noise is not None else
                                qat.draw((batch, *model.latent_shape),
                                         generator, x.device))
        return out

    def draws_for(self, state, x: torch.Tensor,
                  generator: torch.Generator | None = None, **given) -> dict:
        """:meth:`draw` for a train state's model. On a state split over
        data ranks ``x`` is this rank's rows of the global batch: every rank
        draws for the global batch (the same values, from the same seed) and
        keeps its rows, so a sharded step sees the draws of the one-process
        step; the ``given`` draws are the global batch's too."""
        shards = state.data_size
        if shards == 1:
            return self.draw(state.model, x, generator, **given)
        rows = x.shape[0]
        every = x.new_empty((rows * shards, *x.shape[1:]))
        draws = self.draw(state.model, every, generator, **given)
        start = state.data_rank * rows
        return {name: value[start:start + rows]
                for name, value in draws.items()}

    def compute_loss(self, state, generator: torch.Generator | None,
                     x: torch.Tensor, remat: bool = False,
                     has_aux: bool = False, **given):
        """``(loss, grads)`` of the state's model on flat examples ``x``:
        the JAX package's ``compute_loss(state, key, x)``, the reference's
        loss-strategy API, and the differentiation of every train step.
        The draws come from ``generator`` (or ``given``, as in
        :meth:`loss`); ``grads`` holds one gradient per tensor of
        ``state.params``, in that order (``TrainState.apply_gradients``
        takes them so), this rank's alone on a state split over data ranks.
        ``remat`` recomputes the loss in the backward pass, with the same
        draws (``jax.checkpoint`` of the loss); ``has_aux`` returns
        ``((loss, aux), grads)``, as ``jax.value_and_grad`` does."""
        with tracing.span("step.draws"):
            draws = self.draws_for(state, x, generator, **given)

        def loss_fn():
            return self.loss(state.model, x, **draws)

        with tracing.span("step.forward"):
            loss, aux = (checkpoint(loss_fn, use_reentrant=False) if remat
                         else loss_fn())
        with tracing.span("step.backward"):
            grads = list(torch.autograd.grad(loss, state.params))
        loss = loss.detach()
        return ((loss, aux) if has_aux else loss), grads

    def _encode(self, model: nn.Module, x: torch.Tensor,
                qat_noise: torch.Tensor | None = None) -> torch.Tensor:
        """Encoder latents, through the latent QAT when it is set."""
        latents = model.encode(x)
        if self.latent_qat is not None:
            latents = self.latent_qat(latents, noise=qat_noise)
        return latents

    def loss(self, model: nn.Module, x: torch.Tensor,
             generator: torch.Generator | None = None, **given) -> Losses:
        """(loss, {"mse": ...}) for flat examples ``x`` [B, D]; ``given``
        holds any of the draws (:meth:`draw`), the rest come from
        ``generator``."""
        return self._loss(model, x, **self.draw(model, x, generator, **given))

    def _loss(self, model, x, **draws) -> Losses:
        raise NotImplementedError


@dataclass(frozen=True)
class AutoencoderObjective(Objective):
    """Deterministic reconstruction: decode(0, t=0, encode(x)) ≈ x.

    Trains encoder and decoder jointly for any flow architecture; for plain
    autoencoders (``MLPMixerAutoencoder``) ``direct_call=True`` takes
    ``model(x)`` instead, and then no latent QAT applies.
    ``use_weighted_loss`` takes the weighted L2 in place of the plain mean
    squared error; ``aux["mse"]`` is the mean squared error either way."""

    use_weighted_loss: bool = False
    direct_call: bool = False
    latent_qat: LatentQAT | None = None
    _noise = False

    def draw(self, model, x, generator=None, **given) -> dict:
        # model(x) sees no latents, so nothing is drawn for their QAT
        return {} if self.direct_call else super().draw(model, x, generator,
                                                        **given)

    def _loss(self, model, x, qat_noise=None) -> Losses:
        if self.direct_call:
            recon = model(x)
        else:
            latents = self._encode(model, x, qat_noise)
            time = _time_pair(torch.zeros((x.shape[0], 1), dtype=x.dtype,
                                          device=x.device))
            recon = model(torch.zeros_like(x), time, latents)
        loss = (weighted_l2_loss if self.use_weighted_loss else mse_loss)(
            recon, x)
        return loss, {"mse": mse_loss(recon, x).detach()}


@dataclass(frozen=True)
class FlowMatchingObjective(Objective):
    """Conditional flow matching on the schedule's interpolant and target."""

    noise_schedule: Any = field(default_factory=LinearNoiseSchedule)
    time_sampling: Any = field(default_factory=LogitNormalTimeSampling)
    use_weighted_loss: bool = True
    #: 'uniform' | 'time_dependent' | 'learned' (see ops.losses)
    loss_weighting: str = "uniform"
    latent_qat: LatentQAT | None = None
    _times = 1

    def _loss(self, model, x, noise, t, qat_noise=None) -> Losses:
        noised = self.noise_schedule.interpolate(x, noise, t)
        target = self.noise_schedule.compute_target(x, noise)
        latents = self._encode(model, x, qat_noise)
        pred = model(noised, _time_pair(t), latents)
        per_fn = (weighted_l2_per_example if self.use_weighted_loss
                  else mse_per_example)
        loss = apply_loss_weighting(per_fn(pred, target), t,
                                    self.loss_weighting, model)
        return loss, {"mse": mse_loss(pred, target).detach()}


def _jvp(model, z, tz, t, r, latents, differentiable: bool):
    """(u, du/dt) of ``model`` at (z, [t, t - r]) along (tz, 1, 0).

    ``differentiable`` False (the stop-gradient) takes du/dt from a dual
    forward under ``no_grad`` and u from a plain forward that keeps its
    graph: a dual forward on the tape would record the tangent branch too
    (the parameters require grad) and keep the tangent of every saved
    activation until it ends, about doubling the step's memory, where JAX
    keeps neither. Only the grad-of-JVP records the dual forward."""
    with (contextlib.nullcontext() if differentiable else torch.no_grad()), \
            fwAD.dual_level(), stage.differentiable_tangents(differentiable):
        z_dual = fwAD.make_dual(z, tz.to(z.dtype))
        t_dual = fwAD.make_dual(t, torch.ones_like(t))
        out = fwAD.unpack_dual(model(z_dual, _time_pair(t_dual, t_dual - r),
                                     latents))
        if differentiable:
            return out.primal, out.tangent
        dudt = out.tangent
    return model(z, _time_pair(t, t - r), latents), dudt


@dataclass(frozen=True)
class MeanFlowObjective(Objective):
    """Mean flow with adaptive reweighting, on the uniform interpolant."""

    time_sampling: MeanFlowTimeSampling = field(
        default_factory=MeanFlowTimeSampling)
    gamma: float = 0.5
    c: float = 1e-3
    #: detach du/dt in the target (True = the paper's setting)
    use_stop_gradient: bool = True
    loss_weighting: str = "uniform"
    latent_qat: LatentQAT | None = None
    _times = 2

    def _loss(self, model, x, noise, t, r, qat_noise=None) -> Losses:
        noised = (1.0 - t) * x + t * noise
        v = noise - x
        latents = self._encode(model, x, qat_noise)
        u, dudt = _jvp(model, noised, v, t, r, latents,
                       not self.use_stop_gradient)
        if self.use_stop_gradient:
            dudt = dudt.detach()
        u_target = v - (t - r).clamp(0.0, 1.0) * dudt
        per = adaptive_weighted_per_example(u - u_target, gamma=self.gamma,
                                            c=self.c)
        loss = apply_loss_weighting(per, t, self.loss_weighting, model)
        return loss, {"mse": mse_loss(u, u_target).detach()}


@dataclass(frozen=True)
class ImprovedMeanFlowObjective(Objective):
    """Improved mean flow: explicit boundary velocity, JVP along (v, 1, 0),
    compound prediction u + (t - r) sg(du/dt) regressed on the schedule's
    target."""

    noise_schedule: Any = field(default_factory=LinearNoiseSchedule)
    time_sampling: MeanFlowTimeSampling = field(
        default_factory=MeanFlowTimeSampling)
    use_weighted_loss: bool = True
    #: detach du/dt in the compound prediction (the paper's setting)
    use_stop_gradient: bool = True
    #: 'uniform' | 'time_dependent' | 'learned' (see ops.losses)
    loss_weighting: str = "uniform"
    latent_qat: LatentQAT | None = None
    _times = 2

    def _loss(self, model, x, noise, t, r, qat_noise=None) -> Losses:
        noised = self.noise_schedule.interpolate(x, noise, t)
        target = self.noise_schedule.compute_target(x, noise)
        latents = self._encode(model, x, qat_noise)
        # with du/dt detached no gradient reaches v, so the boundary forward
        # needs no graph
        boundary = (torch.no_grad() if self.use_stop_gradient
                    else contextlib.nullcontext())
        with boundary:
            v = model(noised, _time_pair(t), latents)
        u, dudt = _jvp(model, noised, v, t, r, latents,
                       not self.use_stop_gradient)
        if self.use_stop_gradient:
            dudt = dudt.detach()
        v_pred = u + (t - r) * dudt
        per_fn = (weighted_l2_per_example if self.use_weighted_loss
                  else mse_per_example)
        loss = apply_loss_weighting(per_fn(v_pred, target), t,
                                    self.loss_weighting, model)
        return loss, {"mse": mse_loss(v_pred, target).detach()}


# the JAX package's aliases, the reference's loss-strategy class names
FlowMatchingLoss = FlowMatchingObjective
MeanFlowLoss = MeanFlowObjective
ImprovedMeanFlowLoss = ImprovedMeanFlowObjective
LossStrategy = Objective

METHODS = ("autoencoder", "flow_matching", "mean_flow", "improved_mean_flow")


def create_loss_strategy(config: CodecConfig) -> Objective:
    """The objective the config (a ``CodecConfig``, which is also the
    sectioned ``TrainFlowConfig``) names, with the JAX package's defaults
    for unset fields: an explicit ``loss_strategy`` wins, else ``method``,
    else ``use_improved_mean_flow`` picks iMF or FM."""
    name = config.loss_strategy
    if name is None:
        if config.method in METHODS:
            name = config.method
        else:
            name = ("improved_mean_flow" if config.use_improved_mean_flow
                    else "flow_matching")

    schedule_kwargs = {}
    if (config.noise_schedule or "linear") == "linear":
        schedule_kwargs = {
            "noise_min": (config.noise_min if config.noise_min is not None
                          else 0.001),
            "noise_max": (config.noise_max if config.noise_max is not None
                          else 0.999),
        }
    noise_schedule = create_noise_schedule(config.noise_schedule,
                                           **schedule_kwargs)
    mean = (config.time_sampling_mean
            if config.time_sampling_mean is not None else -0.4)
    std = (config.time_sampling_std
           if config.time_sampling_std is not None else 1.0)
    # flow_ratio is the legacy name of the r = t proportion
    proportion = config.time_sampling_data_proportion
    if proportion is None:
        proportion = config.flow_ratio if config.flow_ratio is not None else 0.5
    full_proportion = config.time_sampling_full_proportion or 0.0
    time_name = config.time_sampling or "logit_normal"
    if time_name == "uniform":
        time_sampling: Any = UniformTimeSampling()
    elif time_name == "logit_normal":
        time_sampling = LogitNormalTimeSampling(mean=mean, std=std)
    elif time_name == "mean_flow":
        time_sampling = MeanFlowTimeSampling(
            mean=mean, std=std, data_proportion=proportion,
            full_interval_proportion=full_proportion)
    else:
        raise ValueError(f"Unknown time_sampling: {time_name}. Must be one "
                         "of: 'uniform', 'logit_normal', 'mean_flow'")
    # the mean-flow objectives always sample ordered pairs
    mf_sampling = (time_sampling
                   if isinstance(time_sampling, MeanFlowTimeSampling)
                   else MeanFlowTimeSampling(
                       mean=mean, std=std, data_proportion=proportion,
                       full_interval_proportion=full_proportion))
    use_weighted = (config.use_weighted_loss
                    if config.use_weighted_loss is not None else True)
    weighting = config.loss_weighting or "uniform"
    stop_grad = (config.use_stop_gradient
                 if config.use_stop_gradient is not None else True)
    qat = None
    if config.qat_step_frac is not None or config.qat_bits is not None:
        qat = LatentQAT(mode=config.qat_mode or "ste",
                        step_frac=config.qat_step_frac, bits=config.qat_bits)

    if name == "autoencoder":
        return AutoencoderObjective(latent_qat=qat)
    if name == "flow_matching":
        return FlowMatchingObjective(
            noise_schedule=noise_schedule, time_sampling=time_sampling,
            use_weighted_loss=use_weighted, loss_weighting=weighting,
            latent_qat=qat)
    if name == "mean_flow":
        return MeanFlowObjective(
            time_sampling=mf_sampling,
            gamma=config.gamma if config.gamma is not None else 0.5,
            c=config.c if config.c is not None else 1e-3,
            use_stop_gradient=stop_grad, loss_weighting=weighting,
            latent_qat=qat)
    if name == "improved_mean_flow":
        return ImprovedMeanFlowObjective(
            noise_schedule=noise_schedule, time_sampling=mf_sampling,
            use_weighted_loss=use_weighted, use_stop_gradient=stop_grad,
            loss_weighting=weighting, latent_qat=qat)
    raise ValueError(f"Unknown loss_strategy: {name}. Must be one of: "
                     f"{', '.join(repr(m) for m in METHODS)}")
