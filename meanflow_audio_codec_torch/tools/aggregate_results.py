"""Result aggregation CLI: metrics CSV -> grouped mean/std/min/max.

Counterpart of ``meanflow_audio_codec_torch/tools/aggregate_results.py``: the
same CSV in gives the same summary CSV out.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np


def load_rows(path: Path | str) -> list[dict]:
    """CSV rows with numeric type coercion."""
    with Path(path).open() as fh:
        rows = []
        for raw in csv.DictReader(fh):
            row = {}
            for key, value in raw.items():
                if value is None or value == "":
                    continue
                try:
                    row[key] = float(value)
                except ValueError:
                    row[key] = value
            rows.append(row)
        return rows


def group_stats(rows: list[dict], group_keys: tuple[str, ...],
                metric_keys: tuple[str, ...] | None = None) -> list[dict]:
    """Per-group mean/std/min/max for every numeric metric column."""
    if metric_keys is None:
        numeric = {k for row in rows for k, v in row.items()
                   if isinstance(v, float)}
        metric_keys = tuple(sorted(numeric - set(group_keys)))
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
            entry[f"{metric}_mean"] = float(values.mean())
            entry[f"{metric}_std"] = float(values.std(ddof=1)) if len(values) > 1 else 0.0
            entry[f"{metric}_min"] = float(values.min())
            entry[f"{metric}_max"] = float(values.max())
        out.append(entry)
    return out


def write_csv(rows: list[dict], path: Path | str) -> None:
    if not rows:
        return
    keys = sorted({k for row in rows for k in row})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Aggregate evaluation CSV")
    parser.add_argument("--csv", type=Path, default=Path("metrics.csv"))
    parser.add_argument("--out", type=Path, default=Path("aggregated.csv"))
    parser.add_argument("--group-by", nargs="+",
                        default=["method", "architecture", "nfe"])
    args = parser.parse_args(argv)
    rows = load_rows(args.csv)
    summary = group_stats(rows, tuple(args.group_by))
    write_csv(summary, args.out)
    print(f"{len(rows)} rows -> {len(summary)} groups -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
