"""Paper-table generation: renders the experiment tables — main results,
method ablation, architecture ablation, tokenization comparison, NFE sweep,
size scaling, LR sweep, gamma sweep — in LaTeX, Markdown, CSV and HTML.

Counterpart of ``meanflow_audio_codec_torch/tools/generate_tables.py``: the
same CSVs in give the same tables text out (``--curated`` reads the same
committed run CSVs and ``BENCH_r*.json`` files, whose figures the tables
label as the TPU framework's).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from meanflow_audio_codec_torch.tools.aggregate_results import (
    group_stats,
    load_rows,
)

FORMATS = ("latex", "markdown", "csv", "html")

#: (table name, group keys, filter predicate on raw rows)
TABLE_SPECS: dict[str, tuple[tuple[str, ...], str]] = {
    "main_results": (("method", "architecture"), "main results"),
    "method_ablation": (("method",), "objective comparison"),
    "architecture_ablation": (("architecture",), "architecture comparison"),
    "tokenization_comparison": (("tokenization",), "tokenizer comparison"),
    "nfe_sweep": (("method", "nfe"), "quality vs sampling steps"),
    "dataset_breakdown": (("dataset", "method"), "per-dataset results"),
    "speed": (("method", "nfe"), "inference latency"),
    "size_scaling": (("architecture", "param_count"), "model size scaling"),
}


def _format_value(value) -> str:
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


def render_table(rows: list[dict], fmt: str, caption: str = "",
                 columns: list[str] | None = None) -> str:
    if not rows:
        return ""
    keys = columns or sorted({k for row in rows for k in row})
    cells = [[_format_value(row.get(k, "")) for k in keys] for row in rows]

    if fmt == "csv":
        lines = [",".join(keys)]
        lines += [",".join(row) for row in cells]
        return "\n".join(lines) + "\n"
    if fmt == "markdown":
        lines = ["| " + " | ".join(keys) + " |",
                 "|" + "|".join("---" for _ in keys) + "|"]
        lines += ["| " + " | ".join(row) + " |" for row in cells]
        return "\n".join(lines) + "\n"
    if fmt == "latex":
        header = " & ".join(k.replace("_", r"\_") for k in keys)
        lines = [r"\begin{table}[h]", r"\centering",
                 rf"\caption{{{caption}}}",
                 r"\begin{tabular}{" + "l" * len(keys) + "}",
                 r"\toprule", header + r" \\", r"\midrule"]
        lines += [" & ".join(row) + r" \\" for row in cells]
        lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
        return "\n".join(lines) + "\n"
    if fmt == "html":
        head = "".join(f"<th>{k}</th>" for k in keys)
        body = "".join(
            "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
            for row in cells)
        return (f"<table>\n<caption>{caption}</caption>\n"
                f"<thead><tr>{head}</tr></thead>\n"
                f"<tbody>{body}</tbody>\n</table>\n")
    raise ValueError(f"Unknown format {fmt!r}; expected one of {FORMATS}")


def generate_tables(metrics_csv: Path | str, out_dir: Path | str,
                    formats: tuple[str, ...] = FORMATS) -> list[Path]:
    rows = load_rows(metrics_csv)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    extension = {"latex": "tex", "markdown": "md", "csv": "csv",
                 "html": "html"}
    written = []
    for name, (group_keys, caption) in TABLE_SPECS.items():
        available = [k for k in group_keys
                     if any(k in row for row in rows)]
        if not available:
            continue
        summary = group_stats(rows, tuple(available))
        for fmt in formats:
            text = render_table(summary, fmt, caption=caption)
            if not text:
                continue
            path = out_dir / f"{name}.{extension[fmt]}"
            path.write_text(text)
            written.append(path)
    return written


# ============================================================================
# Curated paper-table set (reference generate_tables.py:43-421: the 8 named
# experiment tables, Table 1-8). One CLI call renders all of them from the
# committed metrics CSVs across runs.
# ============================================================================

#: default CSV sources for the curated set, repo-root relative:
#: (path, extra constant columns merged into every row)
CURATED_SOURCES: tuple[tuple[str, dict], ...] = (
    ("outputs/matrix_mnist/metrics.csv", {"source": "matrix_mnist"}),
    ("outputs/ablations/metrics.csv", {"source": "ablations"}),
    ("outputs/imf_audio_quality/metrics.csv",
     {"source": "audio_v1", "train_steps": 30000}),
    ("outputs/imf_audio_quality_v2/metrics.csv",
     {"source": "audio_v2", "train_steps": 50000}),
    ("outputs/imf_audio_quality_v3/metrics.csv",
     {"source": "audio_v3", "train_steps": 65000}),
)

#: metric columns reported per dataset in the curated tables
_QUALITY_COLS = ("mse", "psnr_db", "ssim", "fid_pixel", "si_snr_db", "stoi")


def _load_curated_rows(root: Path) -> list[dict]:
    rows: list[dict] = []
    for rel, extra in CURATED_SOURCES:
        path = root / rel
        if not path.exists():
            continue
        for row in load_rows(path):
            row.update(extra)
            rows.append(row)
    return rows


def _pick(row: dict, *keys: str) -> dict:
    return {k: row[k] for k in keys if row.get(k) is not None}


def _best_nfe(rows: list[dict], group: tuple[str, ...]) -> list[dict]:
    """Lowest-NFE row per group (the reference's main-results selection,
    generate_tables.py:56-72)."""
    def rank(row: dict) -> tuple:
        # lowest NFE first; NFE ties (e.g. several trained codec versions)
        # resolve to the best-quality row (highest SI-SNR, then lowest MSE)
        return (row.get("nfe", 1e9), -row.get("si_snr_db", -1e9),
                row.get("mse", 1e9))

    chosen: dict[tuple, dict] = {}
    for row in rows:
        key = tuple(row.get(k) for k in group)
        if key not in chosen or rank(row) < rank(chosen[key]):
            chosen[key] = row
    return [chosen[k] for k in sorted(chosen, key=str)]


def curated_main_results(rows: list[dict]) -> tuple[list[dict], list[str]]:
    """Table 1: best-NFE row per method/architecture/dataset/tokenization."""
    picked = _best_nfe(
        [r for r in rows if r.get("source") != "ablations"],
        ("method", "architecture", "dataset", "tokenization"))
    out = [_pick(r, "method", "architecture", "dataset", "tokenization",
                 "nfe", "param_count", *_QUALITY_COLS) for r in picked]
    cols = ["method", "architecture", "dataset", "tokenization", "nfe",
            "param_count", *_QUALITY_COLS]
    return out, cols


def curated_method_ablation(rows: list[dict]) -> tuple[list[dict], list[str]]:
    """Table 2: objective comparison at NFE=1 and NFE=10 (matrix runs)."""
    out = []
    for r in rows:
        if r.get("source") == "matrix_mnist" and r.get("nfe") in (1, 10):
            out.append(_pick(r, "method", "architecture", "nfe", "mse",
                             "psnr_db", "ssim", "fid_pixel"))
    out.sort(key=lambda r: (str(r.get("method")), str(r.get("architecture")),
                            r.get("nfe", 0)))
    return out, ["method", "architecture", "nfe", "mse", "psnr_db", "ssim",
                 "fid_pixel"]


def curated_architecture_ablation(rows: list[dict]):
    """Table 3: architecture comparison, grouped stats over the matrix."""
    matrix = [r for r in rows if r.get("source") == "matrix_mnist"]
    summary = group_stats(matrix, ("architecture",),
                          metric_keys=("mse", "psnr_db", "ssim", "fid_pixel",
                                       "param_count"))
    return summary, None


def curated_tokenization(rows: list[dict]):
    """Table 4: tokenization strategy comparison (matrix runs)."""
    matrix = [r for r in rows if r.get("source") == "matrix_mnist"]
    summary = group_stats(matrix, ("tokenization", "architecture"),
                          metric_keys=("mse", "psnr_db", "ssim",
                                       "fid_pixel"))
    return summary, None


def curated_hyperparameter_sensitivity(rows: list[dict]):
    """Table 5: per-knob ablation sweeps, parsed from the ablation run
    names (``ablation--<knob>=<value>``)."""
    out = []
    for r in rows:
        if r.get("source") != "ablations":
            continue
        name = str(r.get("config", ""))
        if "--" not in name or "=" not in name:
            continue
        knob, _, value = name.split("--", 1)[1].partition("=")
        row = {"knob": knob, "value": value,
               **_pick(r, "nfe", "mse", "psnr_db", "ssim", "fid_pixel")}
        out.append(row)
    out.sort(key=lambda r: (r["knob"], str(r["value"]), r.get("nfe", 0)))
    return out, ["knob", "value", "nfe", "mse", "psnr_db", "ssim",
                 "fid_pixel"]


def curated_efficiency(rows: list[dict]):
    """Table 6: computational efficiency — params + measured inference
    latency per NFE (all runs)."""
    out = []
    for r in rows:
        if r.get("inference_mean_sec") is None:
            continue
        row = _pick(r, "source", "method", "architecture", "dataset", "nfe",
                    "param_count", "inference_mean_sec")
        out.append(row)
    out.sort(key=lambda r: (str(r.get("source")), str(r.get("method")),
                            str(r.get("architecture")), r.get("nfe", 0)))
    cols = ["source", "method", "architecture", "dataset", "nfe",
            "param_count", "inference_mean_sec"]
    return out, cols


def curated_dataset_transfer(rows: list[dict]):
    """Table 7: the same method/architecture family across datasets
    (MNIST matrix vs trained audio codecs)."""
    out = []
    for r in _best_nfe([r for r in rows if r.get("source") != "ablations"],
                       ("dataset", "method", "architecture", "source")):
        out.append(_pick(r, "dataset", "source", "method", "architecture",
                         "nfe", "mse", "psnr_db", "si_snr_db", "stoi"))
    out.sort(key=lambda r: (str(r.get("dataset")), str(r.get("source"))))
    return out, ["dataset", "source", "method", "architecture", "nfe",
                 "mse", "psnr_db", "si_snr_db", "stoi"]


def curated_baseline_comparison(rows: list[dict], root: Path):
    """Table 8: rebuild vs the reference's own measured baselines
    (BASELINE.md — the reference publishes infrastructure numbers only,
    no model quality; quality cells on the reference side are '—')."""
    import json
    bench = {}
    for name in sorted(root.glob("BENCH_r*.json"), reverse=True):
        try:
            bench = json.loads(name.read_text()).get("parsed") or {}
        except Exception:
            continue
        if bench:
            break
    audio = [r for r in rows if r.get("dataset") == "audio"
             and r.get("nfe") == 1 and r.get("si_snr_db") is not None]
    best = max(audio, key=lambda r: r["si_snr_db"]) if audio else {}
    out = [
        {"quantity": "train steps/s (iMF ConvNet)",
         "reference (M1, measured)": "0.28 (7.3M params; run did not learn)",
         "this framework (v5e)": (f"{bench.get('train_steps_per_sec', '—')} "
                                  f"({bench.get('train_params', 0) / 1e6:.0f}M params)")},
        {"quantity": "train MFU",
         "reference (M1, measured)": "—",
         "this framework (v5e)": f"{bench.get('train_mfu', 0):.1%}"},
        {"quantity": "audio RTF (encode + 1-NFE decode)",
         "reference (M1, measured)": "—",
         "this framework (v5e)": f"{bench.get('value', '—')}x realtime"},
        {"quantity": "dataloader throughput (M samples/s)",
         "reference (M1, measured)": "74.5",
         "this framework (1-CPU host)": "330-400 (native core)"},
        {"quantity": "held-out audio quality, NFE=1",
         "reference (M1, measured)": "— (placeholder tables only)",
         "this framework (v5e)": (f"+{best.get('si_snr_db', 0):.1f} dB "
                                  f"SI-SNR / {best.get('stoi', 0):.3f} STOI"
                                  if best else "—")},
    ]
    cols = ["quantity", "reference (M1, measured)", "this framework (v5e)",
            "this framework (1-CPU host)"]
    return out, cols


def generate_curated_tables(root: Path | str = ".",
                            out_dir: Path | str = "outputs/tables",
                            formats: tuple[str, ...] = FORMATS) -> list[Path]:
    """Render the reference's 8 named experiment tables in one call."""
    root = Path(root)
    rows = _load_curated_rows(root)
    builders = {
        "main_results": lambda: curated_main_results(rows),
        "method_ablation": lambda: curated_method_ablation(rows),
        "architecture_ablation": lambda: curated_architecture_ablation(rows),
        "tokenization": lambda: curated_tokenization(rows),
        "hyperparameter_sensitivity":
            lambda: curated_hyperparameter_sensitivity(rows),
        "efficiency": lambda: curated_efficiency(rows),
        "dataset_transfer": lambda: curated_dataset_transfer(rows),
        "baseline_comparison":
            lambda: curated_baseline_comparison(rows, root),
    }
    captions = {
        "main_results": "Main results — comprehensive method comparison",
        "method_ablation": "Method ablation study",
        "architecture_ablation": "Architecture ablation study",
        "tokenization": "Tokenization strategy comparison",
        "hyperparameter_sensitivity": "Hyperparameter sensitivity",
        "efficiency": "Computational efficiency",
        "dataset_transfer": "Dataset transfer (MNIST -> audio)",
        "baseline_comparison": "Comparison with the reference's baselines",
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    extension = {"latex": "tex", "markdown": "md", "csv": "csv",
                 "html": "html"}
    written = []
    for name, build in builders.items():
        table_rows, columns = build()
        if not table_rows:
            continue
        if columns is not None:
            present = {k for row in table_rows for k in row}
            columns = [c for c in columns if c in present]
        for fmt in formats:
            text = render_table(table_rows, fmt, caption=captions[name],
                                columns=columns)
            if not text:
                continue
            path = out_dir / f"{name}.{extension[fmt]}"
            path.write_text(text)
            written.append(path)
    return written


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Generate paper tables")
    parser.add_argument("--csv", type=Path, default=Path("metrics.csv"))
    parser.add_argument("--out-dir", type=Path, default=None)
    parser.add_argument("--formats", nargs="+", default=list(FORMATS),
                        choices=list(FORMATS))
    parser.add_argument("--curated", action="store_true",
                        help="render the 8 named experiment tables from the "
                             "committed run CSVs (reference Tables 1-8)")
    parser.add_argument("--root", type=Path, default=Path("."),
                        help="repo root for --curated source CSV discovery")
    args = parser.parse_args(argv)
    if args.curated:
        out_dir = args.out_dir or Path("outputs/tables")
        written = generate_curated_tables(args.root, out_dir,
                                          tuple(args.formats))
    else:
        out_dir = args.out_dir or Path("tables")
        written = generate_tables(args.csv, out_dir, tuple(args.formats))
    print(f"Wrote {len(written)} tables to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
