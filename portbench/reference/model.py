"""Plain float32 ConvNeXt flow decoder and conv encoder of the MeanFlow codec.

Written from the architecture's equations, as functions of a flat dict of
parameters (``weights.REF_NAMES`` gives the names; ``weights.from_port``
maps a ``state_dict`` of the program onto them). Activations are
channels-last ``[B, H, W, C]``.

Decoder stage i, on x ``[B, D]`` with condition c ``[B, E]``:

    h = gelu(x W_in + b_in) W_lift + b_lift          -> [B, S, S, c0]
    h = h W_up + b_up                                -> [B, S, S, C]
    (s, m) = c W_film + b_film;  h = (1 + s) LN(h) + m
    y = LN(conv3x3(h)); y = GRN(gelu(y W_exp + b_exp)); y = y W_con + b_con
    h = h + gamma_ls * y
    h = h W_down + b_down                            -> [B, S, S, c0]
    out = gelu(flat(h) W_bo + b_bo) W_out + b_out;   x' = x + out / N

with LN a scale-free LayerNorm over channels (eps 1e-6), GRN the ConvNeXt-V2
response norm (spatial L2 with 1e-12 inside the root, divided by its channel
mean + 1e-6), gelu the tanh form, and convolutions XLA "SAME"-padded. The
condition is ``emb(t) + emb(h) + latents W_lat`` with ``emb`` the
[cos, sin] sinusoid of 10000-period frequencies. Encoder: ``[B, D]`` as a
``[B, sqrt D, sqrt D, 1]`` grid, two stride-2 3x3 convs each with LN and
gelu, then a dense head.

``Ops`` computes every product in float32 with TF32 off; ``FP8Ops`` rounds
both operands of every product to float8 e4m3 (per-tensor scale) first, the
precision below the codec's bfloat16, which serves as the comparison's
control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Geometry:
    noise_dim: int
    condition_dim: int
    latent_dim: int
    num_blocks: int
    channels: int
    bottleneck: int
    spatial: int
    lift: int
    encoder_channels: int = 16

    @classmethod
    def from_config(cls, config: dict) -> "Geometry":
        """From a v2 config dict (``model`` section) and its MDCT width."""
        model = config["model"]
        opts = model["architecture_options"]
        tok = config["dataset"]["tokenization_config"]
        noise = tok["window_size"] * 2  # stereo tokens
        return cls(noise_dim=noise, condition_dim=model["condition_dimension"],
                   latent_dim=model["latent_dimension"],
                   num_blocks=model["num_blocks"], channels=opts["channels"],
                   bottleneck=opts["bottleneck_dim"], spatial=opts["spatial"],
                   lift=opts["lift_channels"])


class Ops:
    """Products in float32."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b, stride):
        """Channels-last SAME convolution of a square kernel."""
        k = w.shape[-1]
        pads = []
        for size in (x.shape[2], x.shape[1]):  # F.pad wants W first
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        h = F.pad(x.permute(0, 3, 1, 2), pads)
        return F.conv2d(self.q(h), self.q(w), b, stride=stride).permute(0, 2, 3, 1)


class FP8Ops(Ops):
    """Products of float8 e4m3 operands (per-tensor absmax scale), in
    float32 otherwise; the rounding passes gradients and tangents straight
    through."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())


def gelu(x):
    return F.gelu(x, approximate="tanh")


def layer_norm(x, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def grn(x, gamma, beta, eps: float = 1e-6):
    gx = torch.sqrt(x.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + eps)
    return x * (gamma + nx) + beta


def embedding(x, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    args = x[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def encode(p: dict, x: torch.Tensor, geo: Geometry, ops: Ops = Ops()):
    """``[B, D]`` -> ``[B, latent]``."""
    side = math.isqrt(geo.noise_dim)
    h = x.float().reshape(x.shape[0], side, side, 1)
    for i in range(2):
        h = gelu(layer_norm(ops.conv(h, p[f"enc{i}.w"], p[f"enc{i}.b"], 2)))
    return ops.linear(h.reshape(x.shape[0], -1), p["head.w"], p["head.b"])


def stage(p: dict, i: int, x, cond, geo: Geometry, ops: Ops):
    s = f"dec{i}."
    n, side = x.shape[0], geo.spatial
    h = gelu(ops.linear(x, p[s + "in.w"], p[s + "in.b"]))
    h = ops.linear(h, p[s + "lift.w"], p[s + "lift.b"]).reshape(n, side, side, geo.lift)
    h = ops.linear(h, p[s + "up.w"], p[s + "up.b"])
    scale, shift = ops.linear(cond, p[s + "film.w"], p[s + "film.b"]).chunk(2, dim=-1)
    h = (1.0 + scale[:, None, None]) * layer_norm(h) + shift[:, None, None]
    y = layer_norm(ops.conv(h, p[s + "conv.w"], p[s + "conv.b"], 1))
    y = gelu(ops.linear(y, p[s + "exp.w"], p[s + "exp.b"]))
    y = grn(y, p[s + "grn.g"], p[s + "grn.b"])
    y = ops.linear(y, p[s + "con.w"], p[s + "con.b"])
    h = h + p[s + "ls"] * y
    h = ops.linear(h, p[s + "down.w"], p[s + "down.b"])
    h = gelu(ops.linear(h.reshape(n, -1), p[s + "bo.w"], p[s + "bo.b"]))
    return ops.linear(h, p[s + "out.w"], p[s + "out.b"]) / geo.num_blocks + x


def flow(p: dict, x, time, latents, geo: Geometry, ops: Ops = Ops()):
    """The velocity at ``x`` ``[B, D]``, ``time`` ``[B, 2]`` (t, t - r)."""
    cond = (embedding(time[:, 0], geo.condition_dim)
            + embedding(time[:, 1], geo.condition_dim)
            + ops.linear(latents, p["lat.w"]))
    h = x.float()
    for i in range(geo.num_blocks):
        h = stage(p, i, h, cond, geo, ops)
    return h
