"""The reference's parameters: their names and shapes, how the benchmark
draws them from a seed, and the map from the program's ``state_dict`` names.
"""

from __future__ import annotations

import math
import re

import torch

from portbench.reference.model import Geometry

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
    ``[out, in, k, k]`` convolutions)."""
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
    seeded with ``seed``: standard normals scaled per tensor (products by
    1/sqrt(fan-in), layer scales 0.5, GRN 0.1, biases 0.02)."""
    table = shapes(geo)
    sizes = [math.prod(s) for s in table.values()]
    scales = torch.tensor([_scale(n, s) for n, s in table.items()], device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(scales, torch.tensor(sizes, device=device))
    return {name: view.view(shape) for (name, shape), view in
            zip(table.items(), flat.split(sizes))}


def to_port(params: dict[str, torch.Tensor], port_names) -> dict[str, torch.Tensor]:
    """The program's ``state_dict`` of ``params``: every program name mapped
    to the reference's; raises on a name either side lacks."""
    port_names = list(port_names)
    mapped = {n: ref_name(n) for n in port_names}
    missing = set(params) - set(mapped.values())
    if missing or len(set(mapped.values())) != len(port_names):
        raise KeyError(f"names differ: {sorted(missing)[:5]}")
    return {n: params[r] for n, r in mapped.items()}
