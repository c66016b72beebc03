"""Probe: int8 against bf16 matrix-product throughput, a chain of 8
products of 8192 x 8192 operands.

Counterpart of ``meanflow_audio_codec_tpu/tools/probes/probe_int8.py``. The
int8 side is the port's ``ops/quant.int_product_card`` (``torch._int_mm``,
int32 accumulation, each product cast back to int8 as the next operand);
the bf16 side ``torch.mm`` (f32 accumulation, bf16 result). Best of
``--repeats`` timed chains after one warm-up. One JSON row per dtype::

    {"dtype", "ms", "tops"}

``tops`` counts 2 N^3 operations a product.

    python -m meanflow_audio_codec_torch.tools.probes.probe_int8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from meanflow_audio_codec_torch.ops.quant import int_product_card
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    start,
    sweep,
    time_calls,
)

N = 8192
CHAIN = 8


def mm_i8(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b`` eight times, ``b_t`` the [N, K] transpose the int8 product
    takes; int32 sums wrap to int8 as the next operand."""
    x = a
    for _ in range(CHAIN):
        x = int_product_card(x, b_t).to(torch.int8)
    return x


def mm_bf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = a
    for _ in range(CHAIN):
        x = torch.mm(x, b)
    return x


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    n = N
    rng = np.random.default_rng(0)

    def tensor(array: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(array).to(device=device, dtype=dtype)

    a8 = tensor(rng.integers(-127, 127, (n, n), dtype=np.int8))
    b8 = tensor(rng.integers(-127, 127, (n, n), dtype=np.int8))
    abf = tensor(rng.standard_normal((n, n)).astype(np.float32),
                 torch.bfloat16)
    bbf = tensor(rng.standard_normal((n, n)).astype(np.float32),
                 torch.bfloat16)
    b8_t = b8.t().contiguous()

    def run(name: str, fn) -> dict:
        wall = time_calls(fn, device, 1, args.repeats)
        ops = CHAIN * 2 * n ** 3
        return {"dtype": name, "ms": round(wall * 1e3, 2),
                "tops": round(ops / wall / 1e12, 1)}

    return sweep([({"dtype": "int8"}, lambda: run("int8", lambda: mm_i8(
        a8, b8_t))), ({"dtype": "bf16"}, lambda: run("bf16", lambda: mm_bf(
            abf, bbf)))])


if __name__ == "__main__":
    raise SystemExit(main())
