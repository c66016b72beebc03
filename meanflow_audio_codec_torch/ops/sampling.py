"""Samplers; counterparts of ``sample`` (Heun ODE integration, flow
matching) and ``sample_dual_time`` (mean-flow intervals) in
``meanflow_audio_codec_tpu/ops/sampling.py``."""

from __future__ import annotations

import torch


def _velocity(model, x: torch.Tensor, time: torch.Tensor,
              latents: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """Model velocity with classifier-free guidance; the conditional and
    unconditional (zero-latent) rows share one forward pass."""
    if guidance_scale == 1.0:
        return model(x, time, latents)
    batch = x.shape[0]
    v2 = model(torch.cat([x, x]), torch.cat([time, time]),
               torch.cat([latents, torch.zeros_like(latents)]))
    v_cond, v_uncond = v2[:batch], v2[batch:]
    return guidance_scale * v_cond + (1.0 - guidance_scale) * v_uncond


@torch.no_grad()
def sample(model, noise_dimension: int, latents: torch.Tensor,
           n_steps: int = 100, guidance_scale: float = 1.0,
           noise: torch.Tensor | None = None,
           generator: torch.Generator | None = None,
           use_improved_mean_flow: bool = False) -> torch.Tensor:
    """Heun (RK2) integration of the instantaneous velocity from t=1 to 0;
    ``use_improved_mean_flow`` takes :func:`sample_dual_time` instead.

    The grid is the JAX package's: ``ts = linspace(1, 0, n_steps)`` with
    ``dt = 1/n_steps``, each step evaluating at t and at t - dt (so with
    more than one step the last evaluation is at t = -dt). ``noise``
    (``[B, noise_dimension]``) fixes the start point; otherwise it is drawn
    from ``generator`` on the latents' device. The state stays float32.
    """
    if latents is None:
        raise ValueError("latents must be provided for conditional sampling")
    if use_improved_mean_flow:
        return sample_dual_time(model, noise_dimension, latents,
                                n_steps=n_steps, guidance_scale=guidance_scale,
                                noise=noise, generator=generator)
    batch, device = latents.shape[0], latents.device
    if noise is None:
        noise = torch.randn((batch, noise_dimension), generator=generator,
                            device=device, dtype=torch.float32)
    x = noise.to(device=device, dtype=torch.float32)
    dt = 1.0 / n_steps
    for t in torch.linspace(1.0, 0.0, n_steps, dtype=torch.float32,
                            device=device):
        t1 = t.expand(batch, 1)
        k1 = _velocity(model, x, torch.cat([t1, torch.zeros_like(t1)], -1),
                       latents, guidance_scale)
        t2 = t1 - dt
        k2 = _velocity(model, x - dt * k1.to(x.dtype),
                       torch.cat([t2, torch.zeros_like(t2)], -1), latents,
                       guidance_scale)
        x = x - (dt / 2.0) * (k1 + k2).to(x.dtype)
    return x


@torch.no_grad()
def sample_dual_time(model, noise_dimension: int, latents: torch.Tensor,
                     n_steps: int = 1, guidance_scale: float = 1.0,
                     heun: bool = False, noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Interval sampler from t=1 to 0: ``x <- x - (t-r) * u(x, (t, t-r))``.

    ``n_steps=1`` is the 1-NFE codec decode. ``heun=True`` adds a second
    evaluation at (r, 0) per interval. ``noise`` (``[B, noise_dimension]``)
    fixes the start point; otherwise it is drawn from ``generator`` on the
    latents' device. The state ``x`` stays float32.
    """
    if latents is None:
        raise ValueError("latents must be provided for conditional sampling")
    batch, device = latents.shape[0], latents.device
    if noise is None:
        noise = torch.randn((batch, noise_dimension), generator=generator,
                            device=device, dtype=torch.float32)
    x = noise.to(device=device, dtype=torch.float32)
    t_vals = torch.linspace(1.0, 0.0, n_steps + 1, dtype=torch.float32,
                            device=device)
    for i in range(n_steps):
        t = t_vals[i].expand(batch, 1)
        r = t_vals[i + 1].expand(batch, 1)
        dt = t - r
        u = _velocity(model, x, torch.cat([t, dt], dim=-1), latents,
                      guidance_scale)
        if heun:
            u2 = _velocity(model, x - dt * u.to(x.dtype),
                           torch.cat([r, torch.zeros_like(r)], dim=-1),
                           latents, guidance_scale)
            u = 0.5 * (u + u2)
        x = x - dt * u.to(x.dtype)
    return x
