"""The ``convnet`` family: plain float32 ConvNeXt flow decoder and conv
encoder of the MeanFlow codec, its parameters and their program names.

Written from the architecture's equations, as functions of a flat dict of
parameters (``shapes`` gives the names; ``ref_name`` maps a ``state_dict``
name of the program onto them). Activations are channels-last ``[B, H, W,
C]``.

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

What every family module gives the benchmark: ``Geometry.from_config``
(with ``noise_dim``, the width of one example row), ``shapes``, ``draw``,
``ref_name``, ``to_port``, ``encode``, ``flow``, ``latent_shape`` and
``ROW_BLOCKS``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch

from portbench.reference import weights
from portbench.reference.layers import Ops, embedding, gelu, layer_norm

#: rows per block of the reference's passes, so that each fits on the card
#: beside the window's freed program: a training block keeps every
#: activation of the loss's forward, JVP and backward
ROW_BLOCKS = {"encode": 8192, "decode": 4096, "loss": 512}


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


def latent_shape(geo: Geometry) -> tuple[int, ...]:
    """The shape of one row's latent, as ``encode`` gives it."""
    return (geo.latent_dim,)


def grn(x, gamma, beta, eps: float = 1e-6):
    gx = torch.sqrt(x.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + eps)
    return x * (gamma + nx) + beta


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


#: the program's name pattern -> the reference's name
_PORT_TO_REF = [
    (r"stages\.(\d+)\.bottleneck_in\.", r"dec\1.in."),
    (r"stages\.(\d+)\.lift_conv\.", r"dec\1.up."),
    (r"stages\.(\d+)\.lift\.", r"dec\1.lift."),
    (r"stages\.(\d+)\.film\.proj\.", r"dec\1.film."),
    (r"stages\.(\d+)\.block\.conv\.", r"dec\1.conv."),
    (r"stages\.(\d+)\.block\.expand\.", r"dec\1.exp."),
    (r"stages\.(\d+)\.block\.grn\.gamma$", r"dec\1.grn.g"),
    (r"stages\.(\d+)\.block\.grn\.beta$", r"dec\1.grn.b"),
    (r"stages\.(\d+)\.block\.contract\.", r"dec\1.con."),
    (r"stages\.(\d+)\.block\.layer_scale$", r"dec\1.ls"),
    (r"stages\.(\d+)\.unlift_conv\.", r"dec\1.down."),
    (r"stages\.(\d+)\.bottleneck_out\.", r"dec\1.bo."),
    (r"stages\.(\d+)\.out\.", r"dec\1.out."),
    (r"latent_proj\.", "lat."),
    (r"encoder\.convs\.(\d)\.", r"enc\1."),
    (r"encoder\.head\.", "head."),
]


def ref_name(port_name: str) -> str:
    for pattern, repl in _PORT_TO_REF:
        name, hits = re.subn(pattern, repl, port_name)
        if hits:
            return re.sub(r"\.weight$", ".w", re.sub(r"\.bias$", ".b", name))
    raise KeyError(f"no reference name for {port_name!r}")


def shapes(geo: Geometry) -> dict[str, tuple[int, ...]]:
    """Every reference parameter and its shape (``[out, in]`` products,
    ``[out, in, k, k]`` convolutions), in the order they are drawn."""
    d, e, c, b, s, c0 = (geo.noise_dim, geo.condition_dim, geo.channels,
                         geo.bottleneck, geo.spatial, geo.lift)
    out: dict[str, tuple[int, ...]] = {}
    for i in range(geo.num_blocks):
        p = f"dec{i}."
        for name, shape in (("in", (b, d)), ("lift", (s * s * c0, b)),
                            ("up", (c, c0)), ("film", (2 * c, e)),
                            ("conv", (c, c, 3, 3)), ("exp", (2 * c, c)),
                            ("con", (c, 2 * c)), ("down", (c0, c)),
                            ("bo", (b, s * s * c0)), ("out", (d, b))):
            out[p + name + ".w"] = shape
            out[p + name + ".b"] = (shape[0],)
            if name == "exp":
                out[p + "grn.g"] = (2 * c,)
                out[p + "grn.b"] = (2 * c,)
            if name == "con":
                out[p + "ls"] = (c,)
    out["lat.w"] = (e, geo.latent_dim)
    ec = geo.encoder_channels
    out["enc0.w"], out["enc0.b"] = (ec, 1, 3, 3), (ec,)
    out["enc1.w"], out["enc1.b"] = (2 * ec, ec, 3, 3), (2 * ec,)
    side = -(-math.isqrt(d) // 4)
    out["head.w"], out["head.b"] = (geo.latent_dim, side * side * 2 * ec), (geo.latent_dim,)
    return out


def _scale(name: str, shape: tuple[int, ...]) -> float:
    if name.endswith(".w"):
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith(".ls"):
        return 0.5
    if ".grn." in name:
        return 0.1
    return 0.02  # biases


def draw(geo: Geometry, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter, float32 on ``device``, from one draw of a generator
    seeded with ``seed``: products by 1/sqrt(fan-in), layer scales 0.5, GRN
    0.1, biases 0.02."""
    return weights.draw(shapes(geo), _scale, seed, device)


def to_port(params: dict[str, torch.Tensor], port_names) -> dict[str, torch.Tensor]:
    """The program's ``state_dict`` of ``params``; raises on a name either
    side lacks."""
    return weights.to_port(params, port_names, ref_name)
