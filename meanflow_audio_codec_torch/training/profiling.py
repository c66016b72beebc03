"""Training profiler: step timing, memory, FLOPs and MFU.

Counterpart of ``meanflow_audio_codec_tpu/training/profiling.py`` with the
same record keys (``step_time``, ``avg_step_time``, ``achieved_tflops``,
``mfu``, ``memory``); its summary adds ``phase_ms``, each step phase's
mean device ms a step. On the card:

  * ``ProfilingTrainer`` turns the span store (``tracing``) on from
    ``before_step`` to ``after_step`` and reads the chunk's time from its
    ``train.chunk`` span: the chunk's device time, from CUDA events, read
    once the chunk has finished; ``device_time`` times repeated calls of
    one function on the host's clock, their end forced by
    ``force_completion`` (a synchronize and a host read);
  * ``device_memory_stats`` reads ``torch.cuda.memory_allocated`` /
    ``max_memory_allocated`` and the card's total memory;
  * ``estimate_step_flops`` counts one probe step by the FLOP formulas of
    ``torch.utils.flop_counter`` (matrix products and convolutions:
    forward, forward-mode tangent and backward);
  * ``mfu`` divides by the card's dense bf16 peak, looked up by its name
    (:data:`PEAK_BF16_FLOPS`); a card that is not in the table gets no MFU;
  * ``TraceCapture(logdir)`` records ``torch.profiler``'s host and card
    timeline and the program's spans and writes them as a Chrome trace
    under ``logdir`` (the JAX package's xprof trace).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from meanflow_audio_codec_torch import tracing
from meanflow_audio_codec_torch.device import resolve_device

#: dense bf16 peak FLOP/s by card name (NVIDIA's H100 SXM data sheet; the
#: SXM part reports itself as "NVIDIA H100 80GB HBM3")
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12,
                   "NVIDIA H100 SXM5 80GB": 989.4e12}


def peak_flops(device: torch.device | str) -> float | None:
    """The dense bf16 peak of ``device``'s card, or None (CPU, unknown)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def synchronize(device: torch.device | str) -> None:
    """Wait for ``device``'s queued work (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensors(out) -> list[torch.Tensor]:
    """The tensors of ``out``: a tensor, or a tuple, list or dict of them
    (nested)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, Mapping):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for item in out for t in _tensors(item)]
    return []


def force_completion(out) -> float:
    """Wait for the card's work behind ``out`` (a tensor, or a tuple, list
    or dict of them): ``torch.cuda.synchronize`` on each card it lies on,
    then a host read of one element of its last tensor, which is
    returned (0.0 when it holds none)."""
    tensors = _tensors(out)
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    leaves = [t for t in tensors if t.numel()]
    return float(leaves[-1].reshape(-1)[0].item()) if leaves else 0.0


def device_time(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then ``iters``
    calls timed together on the host's clock, each group ended by
    :func:`force_completion` of the last call's output."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    force_completion(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    force_completion(out)
    return (time.perf_counter() - t0) / iters


def device_memory_stats(device: torch.device | str) -> dict:
    """Memory of the card the run trains on, and the host's resident set."""
    device = torch.device(device)
    stats: dict[str, Any] = {}
    if device.type == "cuda":
        stats[str(device)] = {
            "bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory,
        }
    try:
        import psutil
    except ImportError:
        return stats
    stats["host_rss_bytes"] = psutil.Process().memory_info().rss
    return stats


class _FlopCount(TorchDispatchMode):
    """Sums the FLOPs of every operation ``torch.utils.flop_counter`` has a
    formula for (matrix products, convolutions, attention), forward and
    forward-mode tangents and backward alike. ``FlopCounterMode`` itself
    also tracks modules, with hooks that forward-mode AD breaks."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def estimate_step_flops(probe, *args) -> float | None:
    """FLOPs of one call of ``probe(*args)`` by the formulas of
    ``torch.utils.flop_counter`` (None when it counts none)."""
    with _FlopCount() as counter:
        probe(*args)
    return float(counter.total) or None


class ProfilingTrainer:
    """Device time, memory and MFU instrumentation around the train loop,
    on the card unless the caller passes ``device="cpu"`` (raises when there
    is no card)."""

    def __init__(self, log_writer=None, window: int = 100,
                 flops_per_step: float | None = None,
                 device: torch.device | str = "cuda"):
        self.log = log_writer
        self.window = window
        self.flops_per_step = flops_per_step
        self.device = resolve_device(device)
        self.peak = peak_flops(self.device)
        self.step_times: list[float] = []
        self._phase_ms: defaultdict[str, float] = defaultdict(float)
        self._steps = 0
        self._t_start = 0.0
        self.param_count: int | None = None

    # ---- lifecycle ----------------------------------------------------------
    def start_training(self, param_count: int | None = None) -> None:
        self.param_count = param_count
        self._t_start = time.perf_counter()
        if self.log is not None:
            self.log.write_step(0, event="start", param_count=param_count,
                                memory=device_memory_stats(self.device))

    def before_step(self) -> None:
        tracing.on()

    def _rates(self, seconds: float) -> dict:
        if not self.flops_per_step:
            return {}
        rates = {"achieved_tflops": self.flops_per_step / seconds / 1e12}
        if self.peak:
            rates["mfu"] = self.flops_per_step / seconds / self.peak
        return rates

    def after_step(self, step: int) -> dict:
        """The record of the chunk since :meth:`before_step`: its
        ``train.chunk`` span's device time (``step_time``); the step
        phases' device times add up for :meth:`end_training`."""
        try:
            spans = tracing.collect()
        finally:
            tracing.off()
        chunks = [s for s in spans if s.name == "train.chunk"]
        if not chunks:
            raise RuntimeError("no train.chunk span since before_step()")
        elapsed = sum(s.device_ms for s in chunks) / 1e3
        for s in spans:
            if s.name.startswith("step."):
                self._phase_ms[s.name[5:]] += s.device_ms
        self._steps += sum(s.name == "step" for s in spans)
        self.step_times.append(elapsed)
        if len(self.step_times) > self.window:
            self.step_times.pop(0)
        avg = sum(self.step_times) / len(self.step_times)
        record = {"step_time": elapsed, "avg_step_time": avg,
                  **self._rates(avg)}
        if step % self.window == 0:
            record["memory"] = device_memory_stats(self.device)
        return record

    def end_training(self, total_steps: int) -> dict:
        total = time.perf_counter() - self._t_start
        summary = {
            "total_time_sec": total,
            "total_time_hours": total / 3600.0,
            "steps_per_sec": total_steps / total if total > 0 else None,
            "param_count": self.param_count,
            "phase_ms": {name: ms / self._steps
                         for name, ms in self._phase_ms.items()},
        }
        if self.step_times:
            summary.update(self._rates(
                sum(self.step_times) / len(self.step_times)))
        return summary


class TraceCapture:
    """Context manager around ``torch.profiler``: on exit the timeline (the
    host's ops and, with a card, its kernels) is written to
    ``logdir/trace_<ms>.json`` (``path``), viewable in Perfetto or
    ``chrome://tracing``, with the program's spans (``tracing``, recorded
    while it is active) on the profiler's clock: category
    ``program_span``, device and self ms, ids and counts in ``args``."""

    def __init__(self, logdir: Path | str):
        self.logdir = Path(logdir)
        self.path: Path | None = None
        self._profiler = None
        self._spans: list = []

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        tracing.on(self._spans)
        self._profiler.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._profiler.__exit__(*exc)
            tracing.collect()
        finally:
            tracing.off(self._spans)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.path = self.logdir / f"trace_{int(time.time() * 1000)}.json"
        self._profiler.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        base_ns = trace.get("baseTimeNanoseconds", 0)
        pid = os.getpid()
        trace["traceEvents"].extend(
            {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
             "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "request": s.request,
                      "device_ms": s.device_ms, "self_ms": s.self_ms,
                      **s.counts}}
            for s in self._spans)
        self.path.write_text(json.dumps(trace))
