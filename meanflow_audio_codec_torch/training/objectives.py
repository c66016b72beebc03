"""The improved mean-flow (iMF) training objective.

Counterpart of ``ImprovedMeanFlowObjective`` and ``create_loss_strategy`` in
``meanflow_audio_codec_tpu/training/objectives.py``:

    v = f(z, [t, 0], lat)                   (boundary: u(z, t, t) = v(z, t))
    (u, du/dt) = jvp(f, (z, t, r), (v, 1, 0))
    v_pred = u + (t - r) sg(du/dt);  L = w ||v_pred - target||^2

The JVP is PyTorch's forward-mode AD (``torch.autograd.forward_ad``): z gets
the tangent v and t the tangent 1, so h = t - r gets tangent 1 from the
autodiff itself. The model signature is ``model(z, time, latents)`` with
``time = [t, h]`` columns, and ``model.encode(x)``.

The flow-matching, mean-flow and autoencoder objectives and the latent QAT
hook are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from meanflow_audio_codec_torch.configs import CodecConfig
from meanflow_audio_codec_torch.ops.losses import (
    apply_loss_weighting,
    mse_loss,
    mse_per_example,
    weighted_l2_per_example,
)
from meanflow_audio_codec_torch.ops.schedules import (
    LinearNoiseSchedule,
    create_noise_schedule,
)
from meanflow_audio_codec_torch.ops.time_sampling import MeanFlowTimeSampling


def _time_pair(t: torch.Tensor, h: torch.Tensor | None = None) -> torch.Tensor:
    """Stack (t, h) columns; h defaults to 0 (instantaneous velocity)."""
    if h is None:
        h = torch.zeros_like(t)
    return torch.cat([t, h], dim=-1)


@dataclass(frozen=True)
class ImprovedMeanFlowObjective:
    """Improved mean flow: explicit boundary velocity, JVP along (v, 1, 0),
    compound prediction u + (t - r) sg(du/dt) regressed on the schedule's
    target."""

    noise_schedule: object = field(default_factory=LinearNoiseSchedule)
    time_sampling: MeanFlowTimeSampling = field(
        default_factory=MeanFlowTimeSampling)
    use_weighted_loss: bool = True
    #: detach du/dt in the compound prediction (the paper's setting)
    use_stop_gradient: bool = True
    #: 'uniform' | 'time_dependent' (see ops.losses)
    loss_weighting: str = "uniform"

    def __post_init__(self) -> None:
        if not self.use_stop_gradient:
            raise NotImplementedError(
                "use_stop_gradient=False (gradient through the JVP tangent) "
                "is not ported yet")

    def loss(self, model: nn.Module, x: torch.Tensor,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None, t: torch.Tensor | None = None,
             r: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(loss, {"mse": ...}) for flat examples ``x`` [B, D].

        ``noise`` [B, D] and the ``t``/``r`` columns [B, 1] are drawn from
        ``generator`` unless given (tests pass in what the JAX loss drew).
        """
        batch = x.shape[0]
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
        if (t is None) != (r is None):
            raise ValueError("pass both t and r, or neither")
        if t is None:
            t, r = self.time_sampling.sample_time_pair(
                batch, generator, dtype=x.dtype, device=x.device)
        noised = self.noise_schedule.interpolate(x, noise, t)
        target = self.noise_schedule.compute_target(x, noise)
        latents = model.encode(x)

        # du/dt is detached, so no gradient reaches v: the boundary forward
        # needs no graph
        with torch.no_grad():
            v = model(noised, _time_pair(t), latents)
        with fwAD.dual_level():
            z = fwAD.make_dual(noised, v.to(noised.dtype))
            t_dual = fwAD.make_dual(t, torch.ones_like(t))
            u, dudt = fwAD.unpack_dual(
                model(z, _time_pair(t_dual, t_dual - r), latents))
        v_pred = u + (t - r) * dudt.detach()
        per_fn = (weighted_l2_per_example if self.use_weighted_loss
                  else mse_per_example)
        loss = apply_loss_weighting(per_fn(v_pred, target), t,
                                    self.loss_weighting)
        return loss, {"mse": mse_loss(v_pred, target).detach()}


def create_loss_strategy(config: CodecConfig) -> ImprovedMeanFlowObjective:
    """The objective the config names, with the JAX package's defaults for
    unset fields. Only 'improved_mean_flow' is ported."""
    name = config.loss_strategy
    if name is None:
        if config.method in ("autoencoder", "mean_flow", "flow_matching",
                             "improved_mean_flow"):
            name = config.method
        else:
            name = ("improved_mean_flow" if config.use_improved_mean_flow
                    else "flow_matching")
    if name != "improved_mean_flow":
        raise NotImplementedError(f"objective {name!r} is not ported yet "
                                  "(only 'improved_mean_flow')")
    if config.qat_step_frac is not None or config.qat_bits is not None:
        raise NotImplementedError("latent QAT is not ported yet")

    schedule_kwargs = {}
    if (config.noise_schedule or "linear") == "linear":
        schedule_kwargs = {
            "noise_min": (config.noise_min if config.noise_min is not None
                          else 0.001),
            "noise_max": (config.noise_max if config.noise_max is not None
                          else 0.999),
        }
    proportion = config.time_sampling_data_proportion
    if proportion is None:
        proportion = config.flow_ratio if config.flow_ratio is not None else 0.5
    if (config.time_sampling or "logit_normal") not in (
            "uniform", "logit_normal", "mean_flow"):
        raise ValueError(f"Unknown time_sampling: {config.time_sampling}. "
                         "Must be one of: 'uniform', 'logit_normal', "
                         "'mean_flow'")
    # iMF always samples ordered pairs (the JAX package builds a
    # MeanFlowTimeSampling whatever time_sampling names)
    time_sampling = MeanFlowTimeSampling(
        mean=(config.time_sampling_mean
              if config.time_sampling_mean is not None else -0.4),
        std=(config.time_sampling_std
             if config.time_sampling_std is not None else 1.0),
        data_proportion=proportion,
        full_interval_proportion=config.time_sampling_full_proportion or 0.0)
    return ImprovedMeanFlowObjective(
        noise_schedule=create_noise_schedule(config.noise_schedule,
                                             **schedule_kwargs),
        time_sampling=time_sampling,
        use_weighted_loss=(config.use_weighted_loss
                           if config.use_weighted_loss is not None else True),
        use_stop_gradient=(config.use_stop_gradient
                           if config.use_stop_gradient is not None else True),
        loss_weighting=config.loss_weighting or "uniform")
