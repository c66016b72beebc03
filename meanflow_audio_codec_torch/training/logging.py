"""Run records: JSONL step logs, metric aggregation, summaries, plots.

Counterpart of ``meanflow_audio_codec_tpu/training/logging.py``, with the
same on-disk contract: ``workdir/logs/train_log.jsonl`` (one flushed JSON
object per step), ``metadata.json`` at the start of a run, ``summary.json``
at its end, ``config_diff.json`` on resume and the loss-curve PNG under
``workdir/samples``. The PNG needs matplotlib; without it the plot is
skipped with one printed line. ``ProgressBar`` is tqdm, or a line printer
without it.
"""

from __future__ import annotations

import json
import platform
import sys
import time
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from meanflow_audio_codec_torch.configs import diff_dicts
from meanflow_audio_codec_torch.device import resolve_device


def save_json(data: dict, path: Path | str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2, default=str))


class LogWriter:
    """Append-only JSONL writer, flushed per record."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a", encoding="utf-8")

    def write_step(self, step: int, **metrics) -> None:
        record = {"step": int(step)}
        for key, value in metrics.items():
            if value is None:
                continue
            if isinstance(value, (str, dict, list, bool)):
                record[key] = value
            elif isinstance(value, (int, float, np.floating, np.integer)):
                record[key] = float(value)
            elif np.ndim(value) == 0:  # 0-d tensor or array
                record[key] = float(value)
            else:
                record[key] = np.asarray(value).tolist()
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_log(path: Path | str) -> list[dict]:
    records = []
    with Path(path).open() as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


class MetricsAggregator:
    """Post-hoc statistics over logged metrics."""

    def __init__(self, records: Iterable[dict] | None = None):
        self.records: list[dict] = list(records or [])

    @classmethod
    def from_log(cls, path: Path | str) -> "MetricsAggregator":
        return cls(read_log(path))

    def add(self, record: dict) -> None:
        self.records.append(record)

    def series(self, key: str) -> np.ndarray:
        return np.asarray([r[key] for r in self.records if key in r],
                          dtype=np.float64)

    def stats(self, key: str) -> dict:
        values = self.series(key)
        if values.size == 0:
            return {}
        return {
            "mean": float(values.mean()),
            "std": float(values.std()),
            "min": float(values.min()),
            "max": float(values.max()),
            "final": float(values[-1]),
            "best": float(values.min()),
            "p50": float(np.percentile(values, 50)),
            "p90": float(np.percentile(values, 90)),
            "p99": float(np.percentile(values, 99)),
        }

    def trend(self, key: str, window: int = 100) -> dict:
        """First-window vs last-window means and improvement percentage."""
        values = self.series(key)
        if values.size == 0:
            return {}
        head = values[:window].mean()
        tail = values[-window:].mean()
        improvement = ((head - tail) / abs(head) * 100.0) if head else 0.0
        return {"initial": float(head), "final": float(tail),
                "improvement_pct": float(improvement)}


def generate_training_summary(log_path: Path | str, total_time: float,
                              total_steps: int,
                              param_count: int | None = None) -> dict:
    """The summary.json payload."""
    agg = MetricsAggregator.from_log(log_path)
    summary = {
        "total_steps": int(total_steps),
        "total_time_sec": float(total_time),
        "total_time_hours": float(total_time) / 3600.0,
        "steps_per_sec": (total_steps / total_time) if total_time > 0 else None,
        "param_count": param_count,
        "loss": agg.stats("loss"),
        "loss_trend": agg.trend("loss"),
    }
    if agg.series("step_time").size:
        summary["step_time"] = agg.stats("step_time")
    return summary


def collect_experiment_metadata(config: Any,
                                device: torch.device | str = "cuda") -> dict:
    """The metadata.json payload at the start of a run: versions, the
    device the run trains on (the card unless the caller passes
    ``device="cpu"``; raises when there is no card), the config."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    return {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "python_version": sys.version.split()[0],
        "platform": platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_count": torch.cuda.device_count() if on_card else 1,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if on_card else ["cpu"]),
        "config": config.to_dict(),
    }


def experiment_tag(config: Any) -> str:
    """Canonical run name: method--architecture--dataset--tokenization."""
    return "--".join([
        f"method={config.method or 'flow_matching'}",
        f"architecture={config.architecture or 'mlp'}",
        f"dataset={config.dataset or 'mnist'}",
        f"tokenization={config.tokenization_strategy or 'reshape'}",
    ])


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no PNG plot written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_samples(samples: np.ndarray, path: Path | str,
                 grid: tuple[int, int] | None = None) -> None:
    """Save a grid PNG of image samples (``[N, H, W]``, or ``[N, D]`` flat:
    cropped to the largest square, as an MDCT round trip of an image carries
    overlap-add padding)."""
    plt = _pyplot()
    if plt is None:
        return
    samples = np.asarray(samples)
    if samples.ndim == 2:
        side = int(np.sqrt(samples.shape[1]))
        samples = samples[:, :side * side].reshape(-1, side, side)
    n = samples.shape[0]
    if grid is None:
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
    else:
        rows, cols = grid
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.5, rows * 1.5))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(samples[i], cmap="gray")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def plot_loss_curve(log_path: Path | str, out_path: Path | str,
                    key: str = "loss") -> None:
    agg = MetricsAggregator.from_log(log_path)
    values = agg.series(key)
    steps = agg.series("step")
    if values.size == 0:
        return
    plt = _pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(steps[:values.size], values, linewidth=0.8)
    ax.set_xlabel("step")
    ax.set_ylabel(key)
    ax.set_yscale("log")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def generate_config_diff(old: dict, new: dict, out_path: Path | str) -> dict:
    """Write the diff of two v2 config dicts (on resume)."""
    diff = diff_dicts(old, new)
    save_json(diff, out_path)
    return diff


class ProgressBar:
    """tqdm when available, else a line printer every ``print_every``
    updates, as the JAX package's."""

    def __init__(self, total: int, desc: str = "", print_every: int = 50):
        self.total = total
        self.print_every = print_every
        try:
            from tqdm import tqdm
        except ImportError:
            self._bar = None
            self._count = 0
            self._desc = desc
        else:
            self._bar = tqdm(total=total, desc=desc)

    def update(self, n: int = 1, **postfix) -> None:
        if self._bar is not None:
            if postfix:
                self._bar.set_postfix(**postfix)
            self._bar.update(n)
        else:
            self._count += n
            if self._count % self.print_every == 0:
                extras = " ".join(f"{k}={v}" for k, v in postfix.items())
                print(f"{self._desc} {self._count}/{self.total} {extras}")

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()


def append_metrics_csv(path: Path | str, row: dict) -> None:
    """Append a metrics row, writing the header on first use."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    new = not path.exists()
    with path.open("a", encoding="utf-8") as fh:
        if new:
            fh.write(",".join(map(str, row.keys())) + "\n")
        fh.write(",".join(str(v) for v in row.values()) + "\n")
