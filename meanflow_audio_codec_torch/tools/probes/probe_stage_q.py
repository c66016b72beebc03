"""Probe: one decoder stage forward at the codec's row count, bf16 against
W8A8 int8, plus its 3x3 conv alone.

Counterpart of ``meanflow_audio_codec_tpu/tools/probes/probe_stage_q.py``:
a ``ConvStage`` (noise 1024, condition 256, bottleneck 1024, 512 channels
on an 8 x 8 grid, lift 64; seeded random weights) over 26640 rows (16
clips of 10 s at W 576) with ``quantized`` off and on, then the stage's
3x3 conv at ``[26640, 8, 8, 512]`` as ``F.conv2d`` in bf16 and as the
dynamic int8 conv (``ops/quant.int8_conv2d``: quantize, im2col,
``torch._int_mm``, dequantize). Best of ``--repeats`` after one warm-up.
One JSON row per case::

    {"case", "ms"}

    python -m meanflow_audio_codec_torch.tools.probes.probe_stage_q
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from meanflow_audio_codec_torch.models.conv_flow import ConvStage
from meanflow_audio_codec_torch.models.factories import init_weights
from meanflow_audio_codec_torch.ops.quant import int8_conv2d
from meanflow_audio_codec_torch.tools.benchmarks._timing import (
    start,
    sweep,
    time_calls,
)

B = 26640
KW = dict(noise_dimension=1024, condition_dimension=256, num_blocks=8,
          bottleneck_dim=1024, channels=512, spatial=8, lift_channels=64)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    device = start(args.device)
    b = B
    rng = np.random.default_rng(0)

    def bf16(array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array.astype(np.float32)).to(
            device, torch.bfloat16)

    x = bf16(rng.standard_normal((b, 1024)))
    cond = bf16(rng.standard_normal((b, 256)))
    h = bf16(rng.standard_normal((b, 8, 8, 512)))
    k = bf16(rng.standard_normal((3, 3, 512, 512)) * 0.02)
    k_oihw = k.permute(3, 2, 0, 1).contiguous()
    h_nchw = h.permute(0, 3, 1, 2)  # channels-last memory
    k_cl = k_oihw.contiguous(memory_format=torch.channels_last)

    def run(case: str, fn) -> dict:
        with torch.no_grad():
            wall = time_calls(fn, device, 1, args.repeats)
        return {"case": case, "ms": round(wall * 1e3, 1)}

    def stage(quantized: bool):
        with device:
            module = ConvStage(quantized=quantized,
                               compute_dtype=torch.bfloat16, **KW)
        init_weights(module, torch.Generator(device).manual_seed(0))
        return module.eval()

    stages = {q: stage(q) for q in (False, True)}
    cases = [(f"stage quantized={q}",
              lambda q=q: stages[q](x, cond)) for q in (False, True)]
    cases += [("conv3x3 bf16", lambda: F.conv2d(h_nchw, k_cl, padding=1)),
              ("conv3x3 int8(dyn)",
               lambda: int8_conv2d(h, k_oihw, padding=((1, 1), (1, 1))))]
    return sweep(({"case": case}, lambda case=case, fn=fn: run(case, fn))
                 for case, fn in cases)


if __name__ == "__main__":
    raise SystemExit(main())
