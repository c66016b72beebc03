"""Per-knob trend tables for the ablation matrix.

Counterpart of ``meanflow_audio_codec_torch/tools/ablation_tables.py``: the
ablation configs (``tools/generate_configs.py``) encode the swept knob in
the config *name* (``ablation--gamma=0.5``, ``ablation--no_stop_gradient``);
this tool parses the knob family and value out of the ``config`` column of
the evaluation CSV (``evaluate_all --csv``) and writes one markdown table
per family, rows sorted by knob value, one column block per evaluated NFE.

Usage::

    python -m meanflow_audio_codec_torch.tools.ablation_tables \
        --csv outputs/ablations/metrics.csv --out-dir outputs/ablations/tables
"""
from __future__ import annotations

import argparse
from pathlib import Path

from meanflow_audio_codec_torch.tools.aggregate_results import load_rows

#: metrics pulled into each table, in order (missing ones are skipped)
METRICS = ("mse", "psnr_db", "ssim", "fid_pixel")


def parse_knob(config_name: str) -> tuple[str, str] | None:
    """``ablation--gamma=0.5`` -> ('gamma', '0.5');
    ``ablation--no_stop_gradient`` -> ('stop_gradient', 'False');
    ``ablation--unweighted_loss`` -> ('loss_weighting', 'unweighted')."""
    prefix = "ablation--"
    if not config_name.startswith(prefix):
        return None
    body = config_name[len(prefix):]
    if "=" in body:
        knob, value = body.split("=", 1)
        return knob, value
    # boolean / aliased knobs
    if body == "no_stop_gradient":
        return "stop_gradient", "False"
    if body == "unweighted_loss":
        return "loss_weighting", "unweighted"
    return body, "True"


def _sort_key(value: str):
    try:
        return (0, float(value))
    except ValueError:
        return (1, value)


def build_family_tables(rows: list[dict]) -> dict[str, str]:
    """{family: markdown table} from raw evaluation rows."""
    # family -> value -> nfe -> row
    families: dict[str, dict[str, dict[int, dict]]] = {}
    for row in rows:
        parsed = parse_knob(str(row.get("config", "")))
        if parsed is None:
            continue
        knob, value = parsed
        nfe = int(float(row.get("nfe", 1)))
        families.setdefault(knob, {}).setdefault(value, {})[nfe] = row
    tables: dict[str, str] = {}
    for knob, by_value in sorted(families.items()):
        nfes = sorted({n for v in by_value.values() for n in v})
        metrics = [m for m in METRICS
                   if any(m in r and r[m] not in ("", None)
                          for v in by_value.values() for r in v.values())]
        header = [knob] + [f"{m} @nfe{n}" for n in nfes for m in metrics]
        lines = ["| " + " | ".join(header) + " |",
                 "|" + "---|" * len(header)]
        for value in sorted(by_value, key=_sort_key):
            cells = [value]
            for nfe in nfes:
                row = by_value[value].get(nfe, {})
                for m in metrics:
                    raw = row.get(m, "")
                    try:
                        cells.append(f"{float(raw):.4g}")
                    except (TypeError, ValueError):
                        cells.append("—")
            lines.append("| " + " | ".join(cells) + " |")
        tables[knob] = "\n".join(lines) + "\n"
    return tables


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Ablation trend tables")
    parser.add_argument("--csv", type=Path,
                        default=Path("outputs/ablations/metrics.csv"))
    parser.add_argument("--out-dir", type=Path,
                        default=Path("outputs/ablations/tables"))
    args = parser.parse_args(argv)
    rows = load_rows(args.csv)
    tables = build_family_tables(rows)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    for knob, text in tables.items():
        path = args.out_dir / f"ablation_{knob}.md"
        path.write_text(f"### {knob} ablation\n\n{text}")
        print(f"wrote {path}")
    if not tables:
        print("no ablation-- rows found")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
