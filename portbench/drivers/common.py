"""What the drivers share: the configuration's sizes and model family, the
card's clock and the comparison of outputs with the reference."""

from __future__ import annotations

import sys
import time

import torch

from portbench import harness


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


class Phases:
    """Prints how long each phase of a set-up took, on standard error."""

    def __init__(self):
        self.t = now()

    def __call__(self, name: str) -> None:
        t = now()
        print(f"set-up phase {name}: {t - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = t


class Sizes:
    """The sizes a driver reads from a configuration file, and the reference
    of its model family (``family``) with that family's ``geo``."""

    def __init__(self, config: dict):
        self.config = config["config"]
        self.family = harness.family(self.config)
        self.geo = self.family.Geometry.from_config(self.config)
        tok = self.config["dataset"]["tokenization_config"]
        self.window = tok["window_size"]
        self.hop = tok.get("hop_size") or self.window // 2
        self.coeff_scale = tok.get("coeff_scale", 1.0)
        self.gain_norm = tok.get("gain_norm", 0.0)
        self.frame_size = tok["frame_size"]
        self.batch = self.config["base"]["batch_size"]
        self.sample_rate = config["sample_rate"]

    def frames(self, samples: int) -> int:
        if samples < self.window:
            return 1
        return (samples - self.window) // self.hop + 1

    def tok(self) -> dict:
        return dict(window=self.window, hop=self.hop,
                    coeff_scale=self.coeff_scale, gain_norm=self.gain_norm)


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per leading index, |out - ref| / |ref| over the rest (float64)."""
    out, ref = out.double(), ref.double()
    dims = tuple(range(1, ref.ndim))
    return (out - ref).norm(dim=dims) / ref.norm(dim=dims).clamp_min(1e-30)


class Reservoir:
    """Keeps ``size`` items of a stream of unknown length, each with equal
    chance, chosen by a seeded generator."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = item
