"""Performance instrumentation: inference timing, parameter counts, memory
snapshots and a timing context manager.

Counterpart of ``meanflow_audio_codec_tpu/evaluators/performance.py``. On
the card a timed call ends with ``torch.cuda.synchronize`` on the devices
of the tensors it returns; ``count_parameters`` reports the JAX package's
top-level Flax module names (through ``weights.torch_to_flax``);
``memory_usage`` is ``training/profiling.device_memory_stats`` of one
device, whose card entry holds ``bytes_in_use``.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch

from meanflow_audio_codec_torch.training.profiling import device_memory_stats
from meanflow_audio_codec_torch.weights import torch_to_flax


def memory_usage(device: torch.device | str = "cuda") -> dict:
    """``{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` for a
    card (plus the host's resident set when psutil imports)."""
    return device_memory_stats(device)


def force_completion(out) -> None:
    """Wait for the card's work behind ``out`` (a tensor, or a tuple, list
    or dict of them)."""
    if isinstance(out, Mapping):
        out = list(out.values())
    tensors = out if isinstance(out, (list, tuple)) else [out]
    for device in {t.device for t in tensors
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def inference_time(fn: Callable, *args, warmup: int = 5, runs: int = 50,
                   **kwargs) -> dict:
    """Wall-clock statistics of ``fn(*args, **kwargs)`` after ``warmup``
    calls, each timed call ended by :func:`force_completion`."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    force_completion(out)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        force_completion(out)
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "mean_sec": float(arr.mean()),
        "std_sec": float(arr.std()),
        "min_sec": float(arr.min()),
        "max_sec": float(arr.max()),
        "p50_sec": float(np.percentile(arr, 50)),
        "p99_sec": float(np.percentile(arr, 99)),
        "runs": runs,
    }


def _size(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_size(v) for v in tree.values())
    return int(np.size(tree))


def count_parameters(params, architecture: str = "convnet") -> dict:
    """Total and per-module parameter counts of a model, or of a mapping of
    its parameter names to tensors (an ``architecture`` model's), keyed by
    the top-level module names of the JAX package's param tree."""
    if isinstance(params, torch.nn.Module):
        architecture = params.architecture
        params = dict(params.named_parameters())
    tree = torch_to_flax(params, architecture)
    return {"total": _size(tree),
            "by_module": {name: _size(sub) for name, sub in tree.items()}}


class TrainingTimer:
    """Context manager measuring a training span."""

    def __init__(self, name: str = "training"):
        self.name = name
        self.elapsed: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0


@contextlib.contextmanager
def memory_profiler(label: str = "", device: torch.device | str = "cuda"):
    """Yield a dict filled with before/after/delta device memory."""
    snapshot = {"label": label, "before": memory_usage(device)}
    yield snapshot
    snapshot["after"] = memory_usage(device)
    before, after = snapshot["before"], snapshot["after"]
    deltas = {}
    for key in after:
        if (key in before and isinstance(after[key], dict)
                and isinstance(before[key], dict)):
            a = after[key].get("bytes_in_use")
            b = before[key].get("bytes_in_use")
            if a is not None and b is not None:
                deltas[key] = a - b
    snapshot["delta_bytes"] = deltas
