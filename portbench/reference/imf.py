"""Plain float32 codec calls and improved-mean-flow training steps.

Every function takes the model family's reference module ``fam``
(``family_<architecture>.py``: its ``encode``, ``flow``, ``latent_shape``
and ``ROW_BLOCKS``) beside the family's geometry.

Tokens: MDCT tokens divided by ``coeff_scale``, then (with ``gain_norm`` g)
each frame divided by its gain ``sqrt(mean(tok^2) + g^2)``; every frame is
one example ``x`` of width D.

Codec: ``z = encode(x)``; the 1-NFE decode at (t, h) = (1, 1) from noise e
is ``e - u(e, (1, 1), z)``; frames times their gains and ``coeff_scale``,
then the inverse MDCT.

iMF loss with the stop-gradient, per example, for noise e and times r <= t:

    z_t = (1 - t) x + (a + b t) e,  target = b e - x   (a, b = 0.001, 0.999)
    v   = u(z_t, (t, 0), z)                            (no gradient)
    (u, du/dt) = jvp(u(., (t, t - r), z) at (z_t, t) along (v, 1))
    V   = u + (t - r) sg(du/dt);  d = |V - target|^2
    L   = mean(sg(1 / (d + 1e-3)) d)

The tangent comes from ``torch.func.jvp``. Training: gradients of L, the
global-norm clip, AdamW as optax's ``chain(clip_by_global_norm,
adamw)`` (bias-corrected moments, eps outside the root, decoupled weight
decay), the learning rate of linear warmup then constant or cosine to a
final fraction read at the update count before it increments; as the
program's ``training/optim.py``, a config without ``grad_clip_norm`` clips
nothing, and one without ``lr_schedule``, ``warmup_steps`` or
``lr_final_fraction`` takes "constant", 0 and 0.
"""

from __future__ import annotations

import math

import torch
from torch.func import jvp

from portbench.reference import mdct as ref_mdct
from portbench.reference.layers import Ops

NOISE_MIN, NOISE_MAX, WEIGHT_C = 0.001, 0.999, 1e-3


def frames(audio, window, hop, coeff_scale, gain_norm):
    """``[B, T, C]`` audio -> (examples ``[B*nf, D]``, gains ``[B, nf, 1]``)."""
    tok = ref_mdct.tokenize(audio, window, hop) / coeff_scale
    if gain_norm:
        gains = torch.sqrt(tok.square().mean(dim=-1, keepdim=True) + gain_norm ** 2)
        tok = tok / gains
    else:
        gains = torch.ones_like(tok[..., :1])
    return tok.reshape(-1, tok.shape[-1]), gains


def decode(fam, p, latents, gains, noise, geo, window, hop, coeff_scale,
           ops: Ops = Ops()):
    """``[B, nf, *latent]`` latents -> ``[B, T', C]`` audio, in row blocks."""
    b, nf = latents.shape[:2]
    block = fam.ROW_BLOCKS["decode"]
    flat = latents.reshape(b * nf, *fam.latent_shape(geo)).float()
    out = torch.empty_like(noise, dtype=torch.float32)
    ones = torch.ones((min(block, flat.shape[0]), 2), device=flat.device)
    for i in range(0, flat.shape[0], block):
        e, z = noise[i:i + block].float(), flat[i:i + block]
        out[i:i + block] = e - fam.flow(p, e, ones[:e.shape[0]], z, geo, ops)
    tok = out.reshape(b, nf, -1)
    if gains is not None:
        tok = tok * gains.float()
    return ref_mdct.detokenize(tok * coeff_scale, window, hop)


def encode_rows(fam, p, x, geo, ops: Ops = Ops()):
    block = fam.ROW_BLOCKS["encode"]
    return torch.cat([fam.encode(p, x[i:i + block], geo, ops)
                      for i in range(0, x.shape[0], block)])


def roundtrip(fam, p, audio, noise, geo, window, hop, coeff_scale, gain_norm,
              ops: Ops = Ops()):
    """Encode then decode ``[B, T, C]`` audio with start noise ``[B*nf, D]``."""
    x, gains = frames(audio, window, hop, coeff_scale, gain_norm)
    b, nf = gains.shape[:2]
    latents = encode_rows(fam, p, x, geo, ops).reshape(b, nf, -1)
    return decode(fam, p, latents, gains if gain_norm else None, noise, geo,
                  window, hop, coeff_scale, ops)


def imf_loss_sum(fam, p, x, noise, t, r, geo, ops: Ops = Ops()):
    """(sum over these rows of the weighted terms, sum of their d)."""
    zt = (1.0 - t) * x + (NOISE_MIN + NOISE_MAX * t) * noise
    target = NOISE_MAX * noise - x
    latents = fam.encode(p, x, geo, ops)
    with torch.no_grad():
        v = fam.flow(p, zt, torch.cat([t, torch.zeros_like(t)], -1), latents, geo, ops)

    def f(z, tt):
        return fam.flow(p, z, torch.cat([tt, tt - r], -1), latents, geo, ops)

    u, dudt = jvp(f, (zt, t), (v, torch.ones_like(t)))
    pred = u + (t - r) * dudt.detach()
    d = (pred - target).square().sum(dim=-1)
    return ((1.0 / (d + WEIGHT_C)).detach() * d).sum(), d.detach().sum()


def loss_and_grads(fam, p, x, noise, t, r, geo, ops: Ops = Ops()):
    """(loss, {name: gradient}) of the mean over all rows, in row blocks."""
    block = fam.ROW_BLOCKS["loss"]
    leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
    grads = {n: torch.zeros_like(v) for n, v in p.items()}
    total, rows = 0.0, x.shape[0]
    for i in range(0, rows, block):
        s = slice(i, i + block)
        part, _ = imf_loss_sum(fam, leaves, x[s], noise[s], t[s], r[s], geo, ops)
        for n, g in zip(leaves, torch.autograd.grad(part / rows, list(leaves.values()))):
            grads[n] += g
        total += float(part.detach()) / rows
    return total, grads


def learning_rate(count: int, optim: dict) -> float:
    base, warm = optim["base_lr"], optim.get("warmup_steps") or 0
    lr = base
    if optim.get("lr_schedule", "constant") == "cosine":
        final = base * optim.get("lr_final_fraction", 0.0)
        frac = min(max((count - warm) / max(optim["n_steps"] - warm, 1), 0.0), 1.0)
        lr = final + 0.5 * (base - final) * (1.0 + math.cos(math.pi * frac))
    if warm and count < warm:
        lr = base * count / warm
    return lr


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, 0.9, 0.999, 1e-8,
    weight_decay))`` over a dict of float32 parameters."""

    def __init__(self, params: dict, optim: dict):
        self.params = {n: v.detach().clone() for n, v in params.items()}
        self.mu = {n: torch.zeros_like(v) for n, v in params.items()}
        self.nu = {n: torch.zeros_like(v) for n, v in params.items()}
        self.optim, self.count = optim, 0

    def step(self, grads: dict) -> tuple[dict, float]:
        """Apply one update; returns the clipped gradients it used and the
        global norm before the clip."""
        clip = self.optim.get("grad_clip_norm")
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        scale = clip / norm if clip and norm >= clip else 1.0
        lr = learning_rate(self.count, self.optim)
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, self.optim["weight_decay"]
        n = self.count + 1
        used = {}
        for k, g in grads.items():
            g = g * scale
            used[k] = g
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
            upd = (self.mu[k] / (1 - b1 ** n)) / (torch.sqrt(self.nu[k] / (1 - b2 ** n)) + eps)
            self.params[k] = self.params[k] - lr * (upd + wd * self.params[k])
        self.count += 1
        return used, norm


def train_steps(fam, p, batches, draws, geo, tok: dict, optim: dict,
                ops: Ops = Ops()) -> dict:
    """Follow ``len(batches)`` steps from parameters ``p``: per step the
    loss and the global gradient norm before the clip; the first step's
    clipped gradients; the parameters after all."""
    opt, losses, norms, first = AdamW(p, optim), [], [], None
    for audio, (noise, t, r) in zip(batches, draws):
        x, _ = frames(audio, tok["window"], tok["hop"], tok["coeff_scale"],
                      tok["gain_norm"])
        loss, grads = loss_and_grads(fam, opt.params, x, noise, t, r, geo, ops)
        used, norm = opt.step(grads)
        first = used if first is None else first
        losses.append(loss)
        norms.append(norm)
    return {"losses": losses, "grad_norms": norms, "first_grad": first,
            "params": opt.params}
