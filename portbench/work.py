"""The yardstick's arithmetic: the card's peaks, the work a step or a codec
call needs, and the least time the MDCT kernels could take.

FLOPs of the model are counted once per model family and geometry, on the
family reference's forward passes (its ``encode`` and ``flow``) over meta
tensors, with ``torch.utils.flop_counter``'s formulas (products and
convolutions; 2 per multiply-add). A training step needs, per example row:

    encoder   forward + backward            3 F_enc
    decoder   boundary forward v            1 F_dec
              primal u with its tangent     2 F_dec
              backward of the loss via u    2 F_dec

that is ``3 F_enc + 5 F_dec``; no remat recompute and no second primal
forward (the program runs one). A codec call needs ``F_enc + F_dec`` per
row (encode, then one decoder call).

The MDCT of a 2W-sample frame costs the least of the dense product (2W x W
multiply-adds) and the FFT route through a W/2-point complex FFT with its
pre- and post-twiddles, windowing and folding; the inverse the same plus
the overlap-add. Bytes count each input read once and each output written
once (float32). The bound is the larger of ops / f32 peak and bytes / HBM
bandwidth.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

#: published dense peaks by the name the card reports (NVIDIA's H100 SXM
#: data sheet, at its 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "f32": 67e12, "hbm": 3.35e12},
    "NVIDIA H100 SXM5 80GB": {"bf16": 989.4e12, "f32": 67e12, "hbm": 3.35e12},
}


@functools.lru_cache(maxsize=8)
def model_flops_per_row(family, geo) -> tuple[float, float]:
    """(F_enc, F_dec): forward FLOPs of the encoder and of one decoder call
    for one example row of the model ``family`` at ``geo``."""
    rows = 64
    p = {n: torch.empty(s, device="meta") for n, s in family.shapes(geo).items()}
    x = torch.empty(rows, geo.noise_dim, device="meta")
    latents = torch.empty(rows, *family.latent_shape(geo), device="meta")
    counts = []
    for fn in (lambda: family.encode(p, x, geo),
               lambda: family.flow(p, x, torch.empty(rows, 2, device="meta"), latents,
                                   geo)):
        with FlopCounterMode(display=False) as counter:
            fn()
        counts.append(counter.get_total_flops() / rows)
    return counts[0], counts[1]


def train_step_flops(family, geo, rows: int) -> float:
    enc, dec = model_flops_per_row(family, geo)
    return rows * (3 * enc + 5 * dec)


def codec_call_flops(family, geo, rows: int) -> float:
    enc, dec = model_flops_per_row(family, geo)
    return rows * (enc + dec)


def _fft_ops(window: int) -> float:
    """The MDCT of one 2W frame by a W/2-point complex FFT: 5 n log2 n for
    the FFT, two complex twiddles (6 each) per point, the window (2W
    multiplies) and the fold (2W adds)."""
    n = window // 2
    return 5 * n * math.log2(n) + 12 * n + 4 * window


def mdct_ops(frames: int, window: int) -> float:
    return frames * min(4.0 * window * window, _fft_ops(window))


def imdct_ops(frames: int, window: int) -> float:
    return frames * (min(4.0 * window * window, _fft_ops(window)) + 2 * window)


def mdct_bytes(rows: int, length: int, frames: int, window: int) -> float:
    """Signal ``[rows, length]`` read, ``[rows, frames, W]`` written."""
    return 4.0 * rows * (length + frames * window)


def imdct_bytes(rows: int, frames: int, window: int, hop: int) -> float:
    return 4.0 * rows * (frames * window + (frames - 1) * hop + 2 * window)


def bound_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    return max(ops / peaks["f32"], nbytes / peaks["hbm"])
