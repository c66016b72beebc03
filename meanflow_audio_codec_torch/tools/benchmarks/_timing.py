"""What the timing tools share: the card line, the host wall time of a
block of calls, and the per-config sweep with its error rows.

The JAX package's scripts end a timed region with a host read
(``force_completion``). Here a region starts and ends with
``torch.cuda.synchronize``, so the wall time covers all the card's work
the calls queued.

A sweep keeps the JAX scripts' error row for a config that raises (an
out-of-memory at ch2048 still leaves the other rows), but the script's
``main`` then returns 1: no failure passes as a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from collections.abc import Callable, Iterable

import torch

from meanflow_audio_codec_torch.device import resolve_device
from meanflow_audio_codec_torch.training.profiling import synchronize


def card_line(device: torch.device) -> str:
    """``name, power.limit`` of the first card as nvidia-smi prints them
    (the tools run on one), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True,
        timeout=60).stdout
    return out.strip().splitlines()[0]


def start(device: str) -> torch.device:
    """Resolve ``device`` (a card unless ``cpu`` is asked for; raises
    without one) and print the card line, the first line of every tool."""
    resolved = resolve_device(device)
    print(card_line(resolved), flush=True)
    return resolved


class Clock:
    """Times the calls inside a ``with`` block: ``wall`` in host seconds up
    to ``torch.cuda.synchronize``. Work queued before the block is waited
    for first and not counted."""

    def __init__(self, device: torch.device):
        self.device = device
        self.wall = 0.0

    def __enter__(self) -> "Clock":
        synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        synchronize(self.device)
        self.wall = time.perf_counter() - self._t0


def time_calls(fn, device: torch.device, iters: int, groups: int = 1
               ) -> float:
    """Best host seconds per call over ``groups`` groups of ``iters``
    calls, after one warm-up call."""
    fn()
    walls = []
    for _ in range(groups):
        with Clock(device) as clock:
            for _ in range(iters):
                fn()
        walls.append(clock.wall / iters)
    return min(walls)


def sweep(cases: Iterable[tuple[dict, Callable[[], dict]]]) -> int:
    """Run each ``(label, run)`` and print ``run()``'s row as one JSON line,
    or the label with an ``error`` (its traceback to stderr) when it raises;
    1 when any case raised, else 0."""
    failed = 0
    for label, run in cases:
        try:
            row = run()
        except Exception as exc:  # one config's failure: report, go on
            traceback.print_exc(file=sys.stderr)
            row = {**label, "error": f"{type(exc).__name__}: {exc}"[:300]}
            failed = 1
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return failed
