"""How the benchmark draws a family's parameters from a seed, and maps them
onto the program's ``state_dict`` names. Each family gives its own table of
names and shapes, the scale of each tensor and the name map
(``family_<architecture>.py``).
"""

from __future__ import annotations

import math

import torch


def draw(table: dict[str, tuple[int, ...]], scale, seed: int,
         device) -> dict[str, torch.Tensor]:
    """Every parameter of ``table``, float32 on ``device``, from one draw of a
    generator seeded with ``seed``: standard normals in the table's order,
    each tensor times its ``scale(name, shape)``."""
    sizes = [math.prod(s) for s in table.values()]
    scales = torch.tensor([scale(n, s) for n, s in table.items()], device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(scales, torch.tensor(sizes, device=device))
    return {name: view.view(shape) for (name, shape), view in
            zip(table.items(), flat.split(sizes))}


def to_port(params: dict[str, torch.Tensor], port_names,
            ref_name) -> dict[str, torch.Tensor]:
    """The program's ``state_dict`` of ``params``: every program name mapped
    to the reference's by ``ref_name``; raises on a name either side lacks."""
    port_names = list(port_names)
    mapped = {n: ref_name(n) for n in port_names}
    missing = set(params) - set(mapped.values())
    if missing or len(set(mapped.values())) != len(port_names):
        raise KeyError(f"names differ: {sorted(missing)[:5]}")
    return {n: params[r] for n, r in mapped.items()}
