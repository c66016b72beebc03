"""What the per-layer metric readers share. A reader takes the finished
``harness.Run`` and returns a number, or None where its cell gives it
nothing to read; it never returns 0 for a share of a peak or a roofline.
"""

from __future__ import annotations

import re
import statistics

from portbench import work


def mfu_pct(run, flops: float) -> float | None:
    """FLOPs the window's work needs over its time, over the bf16 peak."""
    elapsed = run.window.get("elapsed_s")
    if not flops or not elapsed:
        return None
    return 100.0 * flops / elapsed / run.peaks["bf16"]


def idle_pct(run) -> float | None:
    trace = run.device_trace
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def kernel_roofline_pct(run, kernel: str, bound_s: float) -> float | None:
    """The least time of ``kernel``'s launches (each ``bound_s``) over their
    traced time."""
    trace = run.device_trace
    if trace is None:
        return None
    pattern = re.compile(rf"(?<![A-Za-z0-9_]){kernel}\b")
    seconds, count = trace.kernel_seconds(lambda name: bool(pattern.search(name)))
    if not count or seconds <= 0:
        return None
    return 100.0 * count * bound_s / seconds


def untraced(run) -> tuple[int, int]:
    """The stamps of the window the profiler was off in."""
    return run.window["t0_ns"], run.window["t1_ns"]


def span_ms_median(run, name: str) -> float | None:
    values = run.spans.seconds(name, untraced(run))
    return 1000.0 * statistics.median(values) if values else None


def mdct_bound(run, signal_rows: int, length: int) -> float:
    s = run.window["sizes"]
    frames = s.frames(length)
    return work.bound_seconds(work.mdct_ops(signal_rows * frames, s.window),
                              work.mdct_bytes(signal_rows, length, frames, s.window),
                              run.peaks)


def imdct_bound(run, signal_rows: int, frames: int) -> float:
    s = run.window["sizes"]
    return work.bound_seconds(work.imdct_ops(signal_rows * frames, s.window),
                              work.imdct_bytes(signal_rows, frames, s.window, s.hop),
                              run.peaks)
