"""Probe: int8 against bf16 3x3 convolution throughput at the codec's
grid (batch 8192, 8 x 8, 512 channels, SAME padding).

Counterpart of ``meanflow_audio_codec_tpu/tools/probes/probe_int8_conv.py``.
The int8 side is the port's int8 convolution without its quantize passes:
the padded channels-last codes unfolded into rows
(``ops/quant.unfold_codes``), one ``torch._int_mm`` product
(``ops/quant.int_product_card``) with int32 sums, shifted right by 8 and
cast to int8; the bf16 side ``F.conv2d`` on channels-last activations
(f32 accumulation, bf16 result). Best of ``--repeats`` after one warm-up.
One JSON row per dtype::

    {"dtype", "ms", "tops"}

``tops`` counts 2 B S^2 9 C^2 operations.

    python -m meanflow_audio_codec_torch.tools.probes.probe_int8_conv
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from meanflow_audio_codec_torch.ops.quant import int_product_card, unfold_codes
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    start,
    sweep,
    time_calls,
)

B, S, C = 8192, 8, 512


def conv_i8(x: torch.Tensor, k_rows: torch.Tensor) -> torch.Tensor:
    """``x`` [B, S, S, C] int8 codes, ``k_rows`` [O, C*9] int8 (OIHW
    flattened): the SAME 3x3 conv, int32 sums >> 8 as int8 [B, S, S, O]."""
    rows, (b, ho, wo) = unfold_codes(F.pad(x, (0, 0, 1, 1, 1, 1)), 3, 3)
    y = int_product_card(rows, k_rows)
    return (y >> 8).to(torch.int8).reshape(b, ho, wo, -1)


def conv_bf(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x`` [B, C, S, S] bf16 in channels-last memory, ``k`` OIHW."""
    return F.conv2d(x, k, padding=1)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    b, s, c = B, S, C
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.integers(-127, 127, (b, s, s, c),
                                       dtype=np.int8)).to(device)
    k8 = torch.from_numpy(rng.integers(-127, 127, (3, 3, c, c),
                                       dtype=np.int8)).to(device)
    k8_rows = k8.permute(3, 2, 0, 1).reshape(c, -1).contiguous()  # OIHW
    xbf = torch.from_numpy(rng.standard_normal((b, s, s, c)).astype(
        np.float32)).to(device, torch.bfloat16).permute(0, 3, 1, 2)
    kbf = torch.from_numpy(rng.standard_normal((3, 3, c, c)).astype(
        np.float32)).to(device, torch.bfloat16).permute(3, 2, 0, 1)
    kbf = kbf.contiguous(memory_format=torch.channels_last)

    def run(name: str, fn) -> dict:
        wall = time_calls(fn, device, 1, args.repeats)
        ops = 2 * b * s * s * 9 * c * c
        return {"dtype": name, "ms": round(wall * 1e3, 2),
                "tops": round(ops / wall / 1e12, 1)}

    return sweep([
        ({"dtype": "int8"}, lambda: run("int8", lambda: conv_i8(x8, k8_rows))),
        ({"dtype": "bf16"}, lambda: run("bf16", lambda: conv_bf(xbf, kbf)))])


if __name__ == "__main__":
    raise SystemExit(main())
