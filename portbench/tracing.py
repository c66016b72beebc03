"""Host spans from the benchmark's own files and the device's activity from
``torch.profiler``.

Spans are recorded around the calls into each layer of the program, in
wall-clock nanoseconds (``time.time_ns``, the clock the profiler stamps
its events with), kept in memory and read when the run ends. The device
trace holds every kernel, copy and set of the traced window; its busy time
is the union of their intervals inside the window.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass

import torch


class Spans:
    """Named host intervals ``(name, start_ns, end_ns)``, one after another
    (spans do not nest); off unless ``on``."""

    def __init__(self):
        self.on = False
        self.items: list[tuple[str, int, int]] = []

    @contextmanager
    def __call__(self, name: str, sync: torch.device | None = None):
        """A span around the block; with ``sync`` it ends once the card has
        finished what the block queued (traced runs only)."""
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            if sync is not None and sync.type == "cuda":
                torch.cuda.synchronize(sync)
            self.items.append((name, t0, time.time_ns()))

    def seconds(self, name: str, within: tuple[int, int] | None = None) -> list[float]:
        """Durations of the spans called ``name`` (inside ``within``, a
        pair of ``time_ns`` stamps, when given)."""
        lo, hi = within or (0, 2 ** 63)
        return [(b - a) / 1e9 for n, a, b in self.items
                if n == name and a >= lo and b <= hi]


@dataclass
class DeviceTrace:
    events: list[tuple[str, int, int]]  # name, start_ns, end_ns (clipped)
    window_s: float
    busy_s: float
    t0_ns: int
    t1_ns: int

    def kernel_seconds(self, match) -> tuple[float, int]:
        """Total seconds and count of the events whose name ``match``es."""
        total, count = 0.0, 0
        for name, a, b in self.events:
            if match(name):
                total += (b - a) / 1e9
                count += 1
        return total, count


def _union(intervals: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class DeviceRecorder:
    """``torch.profiler`` over the card's activity during the window."""

    def __init__(self, device: torch.device):
        self.device = device
        # the CPU's own activity stands in for a card's only in tests
        cuda = device.type == "cuda"
        self.kind = (torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU)
        self.profiler = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.profiler.start()

    def stop(self, t0_ns: int, t1_ns: int) -> DeviceTrace:
        self._sync()
        self.profiler.stop()
        events = []
        for e in self.profiler.profiler.kineto_results.events():
            if e.device_type() != self.kind:
                continue
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            a, b = max(a, t0_ns), min(b, t1_ns)
            if b > a:
                events.append((e.name(), a, b))
        busy = _union([(a, b) for _, a, b in events]) / 1e9
        return DeviceTrace(events, (t1_ns - t0_ns) / 1e9, busy, t0_ns, t1_ns)


def idle_gaps(trace: DeviceTrace) -> list[tuple[int, int]]:
    """The window's intervals in which nothing ran on the device."""
    gaps, cursor = [], trace.t0_ns
    for a, b in sorted((a, b) for _, a, b in trace.events):
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if trace.t1_ns > cursor:
        gaps.append((cursor, trace.t1_ns))
    return gaps


def breakdown(trace: DeviceTrace, spans: Spans) -> dict:
    """The ten device operations that took the most time, and the idle time
    summed by the host span open at each gap's middle (``host`` where none
    was)."""
    ops = defaultdict(float)
    for name, a, b in trace.events:
        ops[name[:120]] += (b - a) / 1e9
    items = sorted(spans.items, key=lambda item: item[1])
    starts = [s for _, s, _ in items]
    idle = defaultdict(float)
    for a, b in idle_gaps(trace):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = items[i][0] if i >= 0 and items[i][2] >= mid else "host"
        idle[label] += (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
