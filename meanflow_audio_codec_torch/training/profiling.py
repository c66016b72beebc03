"""Training profiler: step timing, memory, FLOPs and MFU.

Counterpart of ``meanflow_audio_codec_tpu/training/profiling.py`` with the
same record keys (``step_time``, ``avg_step_time``, ``achieved_tflops``,
``mfu``, ``memory``). On the card:

  * a call's time ends with ``torch.cuda.synchronize()``: the trainer times
    one chunk of K steps per call, so the host waits once per chunk;
  * ``device_memory_stats`` reads ``torch.cuda.memory_allocated`` /
    ``max_memory_allocated`` and the card's total memory;
  * ``estimate_step_flops`` counts one probe step by the FLOP formulas of
    ``torch.utils.flop_counter`` (matrix products and convolutions:
    forward, forward-mode tangent and backward);
  * ``mfu`` divides by the card's dense bf16 peak, looked up by its name
    (:data:`PEAK_BF16_FLOPS`); a card that is not in the table gets no MFU.
"""

from __future__ import annotations

import time
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

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
    """Wall-clock, memory and MFU instrumentation around the train loop."""

    def __init__(self, log_writer=None, window: int = 100,
                 flops_per_step: float | None = None,
                 device: torch.device | str = "cpu"):
        self.log = log_writer
        self.window = window
        self.flops_per_step = flops_per_step
        self.device = torch.device(device)
        self.peak = peak_flops(self.device)
        self.step_times: list[float] = []
        self._t_step = 0.0
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
        self._t_step = time.perf_counter()

    def _rates(self, seconds: float) -> dict:
        if not self.flops_per_step:
            return {}
        rates = {"achieved_tflops": self.flops_per_step / seconds / 1e12}
        if self.peak:
            rates["mfu"] = self.flops_per_step / seconds / self.peak
        return rates

    def after_step(self, step: int) -> dict:
        synchronize(self.device)
        elapsed = time.perf_counter() - self._t_step
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
        }
        if self.step_times:
            summary.update(self._rates(
                sum(self.step_times) / len(self.step_times)))
        return summary
