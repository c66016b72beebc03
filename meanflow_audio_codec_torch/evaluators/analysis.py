"""Results analysis: CSV -> grouped statistics -> summary + errorbar plots.

Counterpart of ``meanflow_audio_codec_tpu/evaluators/analysis.py``. The
plots need matplotlib: where it does not import, ``plot_metric_vs_nfe``
writes nothing and returns False, and every number is still written.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def _read_csv(path: Path | str) -> list[dict]:
    with Path(path).open() as fh:
        rows = []
        for row in csv.DictReader(fh):
            coerced = {}
            for key, value in row.items():
                try:
                    coerced[key] = float(value)
                except (TypeError, ValueError):
                    coerced[key] = value
            rows.append(coerced)
        return rows


def aggregate(rows: list[dict], group_keys: tuple[str, ...],
              metric_keys: tuple[str, ...]) -> list[dict]:
    """Group rows and report mean + 1.96*SE confidence intervals."""
    groups: dict[tuple, list[dict]] = {}
    for row in rows:
        key = tuple(row.get(k) for k in group_keys)
        groups.setdefault(key, []).append(row)
    out = []
    for key, members in sorted(groups.items(), key=str):
        entry = dict(zip(group_keys, key))
        entry["n"] = len(members)
        for metric in metric_keys:
            values = np.asarray([m[metric] for m in members
                                 if isinstance(m.get(metric), float)])
            if values.size == 0:
                continue
            mean = values.mean()
            se = values.std(ddof=1) / np.sqrt(len(values)) if len(values) > 1 else 0.0
            entry[f"{metric}_mean"] = float(mean)
            entry[f"{metric}_ci95"] = float(1.96 * se)
        out.append(entry)
    return out


def write_summary_csv(summary: list[dict], path: Path | str) -> None:
    if not summary:
        return
    keys = sorted({k for row in summary for k in row})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=keys)
        writer.writeheader()
        writer.writerows(summary)


def plot_metric_vs_nfe(summary: list[dict], metric: str,
                       out_path: Path | str,
                       series_key: str = "method") -> bool:
    """Errorbar plot of a metric against NFE, one line per series; False
    (nothing written) when matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series: dict[str, list[tuple[float, float, float]]] = {}
    for row in summary:
        name = str(row.get(series_key, ""))
        nfe = row.get("nfe") or row.get("nfe_mean")
        mean = row.get(f"{metric}_mean")
        ci = row.get(f"{metric}_ci95", 0.0)
        if nfe is None or mean is None:
            continue
        series.setdefault(name, []).append((float(nfe), mean, ci))

    fig, ax = plt.subplots(figsize=(6, 4))
    for name, points in sorted(series.items()):
        points.sort()
        xs, ys, es = zip(*points)
        ax.errorbar(xs, ys, yerr=es, marker="o", capsize=3, label=name)
    ax.set_xscale("log")
    ax.set_xlabel("NFE (sampling steps)")
    ax.set_ylabel(metric)
    ax.legend()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return True


def analyze_results(metrics_csv: Path | str, workdir: Path | str,
                    group_keys: tuple[str, ...] = ("nfe", "method"),
                    metric_keys: tuple[str, ...] = ("mse", "psnr_db", "ssim",
                                                    "fid_pixel")) -> list[dict]:
    """CSV -> summary.csv + per-metric errorbar plots under workdir."""
    workdir = Path(workdir)
    rows = _read_csv(metrics_csv)
    summary = aggregate(rows, group_keys, metric_keys)
    write_summary_csv(summary, workdir / "summary.csv")
    for metric in metric_keys:
        if any(f"{metric}_mean" in row for row in summary):
            plot_metric_vs_nfe(summary, metric,
                               workdir / f"{metric}_vs_nfe.png")
    return summary
