"""The general traffic generator: every input a run sends is made here from
``--seed`` and a traffic file's parameters.

- ``clip_bank``: stereo clips, each a sum of a few seeded partials with a
  seeded envelope plus a little noise, peak about 0.5, made on the device.
- ``durations``: whole seconds, each drawn on its own from a lognormal
  (median, sigma) and clipped.
- ``arrivals``: a Poisson process: independent exponential gaps at a rate,
  the first request at 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one named use of the seed."""
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def clip_bank(seed: int, clips: int, samples: int, sample_rate: int, device,
              partials: int = 6, stream: int = 1) -> torch.Tensor:
    """``[clips, samples, 2]`` float32 audio on ``device``."""
    gen = torch_generator(seed, stream, device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    freq = 60.0 * torch.exp(torch.rand(clips, partials, 1, generator=gen, device=device)
                            * math.log(8000.0 / 60.0))
    phase = 2 * math.pi * torch.rand(clips, partials, 2, generator=gen, device=device)
    amp = torch.rand(clips, partials, 2, generator=gen, device=device) / partials
    rate = 0.5 + 4.0 * torch.rand(clips, 1, 1, generator=gen, device=device)
    out = torch.zeros(clips, samples, 2, device=device)
    for k in range(partials):
        arg = 2 * math.pi * freq[:, k, :, None] * t + phase[:, k, :, None]
        out += (amp[:, k, :, None] * torch.sin(arg)).transpose(1, 2)
    envelope = 0.6 + 0.4 * torch.sin(2 * math.pi * rate * t[None, :, None])
    noise = 0.01 * torch.randn(clips, samples, 2, generator=gen, device=device)
    return out * envelope + noise


def durations(seed: int, count: int, median: float, sigma: float, low: int,
              high: int) -> list[int]:
    """``count`` whole-second durations (see the module's note)."""
    values = rng(seed, 2).lognormal(math.log(median), sigma, count)
    return [int(min(max(round(float(v)), low), high)) for v in values]


def arrivals(seed: int, rate: float, count: int) -> list[float]:
    """``count`` arrival times in seconds from 0, mean gap ``1 / rate``."""
    gaps = rng(seed, 3).exponential(1.0 / rate, count - 1)
    return [0.0] + [float(v) for v in np.cumsum(gaps)]
