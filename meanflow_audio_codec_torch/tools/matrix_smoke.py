"""Matrix smoke: train every config of a directory for a few steps.

Counterpart of ``meanflow_audio_codec_tpu/tools/matrix_smoke.py``, with its
tiny overrides and report: each config is loaded, shrunk by
``TINY_OVERRIDES`` (audio also by ``AUDIO_TOK``) and trained end to end
(model build, train steps, sampling, checkpoint) in one process; a config
passes when its final loss is finite.

    python -m meanflow_audio_codec_torch.tools.matrix_smoke \\
        --configs configs --out runs/matrix_smoke [--device cpu]

Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from meanflow_audio_codec_torch.configs import load_config, merge_configs
from meanflow_audio_codec_torch.training.trainer import train_flow

TINY_OVERRIDES = {
    "base": {"n_steps": 2, "batch_size": 4},
    "model": {"num_blocks": 1, "condition_dimension": 16,
              "latent_dimension": 8},
    "training": {"sample_every": 2, "sample_steps": 1,
                 "max_checkpoints_to_keep": 1},
}
# tiny frames keep features-mode configs (audio + reshape flattens frames x
# channels into one vector; mixer stages are quadratic in the flat width)
# at smoke-able sizes
AUDIO_TOK = {"frame_size": 512, "window_size": 256, "patch_length": 128}


def smoke_one(config_path: Path, out_root: Path, device: str = "cuda"
              ) -> tuple[bool, str, float]:
    """(passed, note, seconds) of one config's tiny run."""
    config = load_config(config_path)
    overrides = json.loads(json.dumps(TINY_OVERRIDES))  # deep copy
    overrides["training"]["workdir"] = str(out_root / config_path.stem)
    if config.dataset == "audio":
        overrides["dataset"] = {"tokenization_config": dict(
            config.tokenization_config, **AUDIO_TOK)}
    config = merge_configs(config, overrides)
    t0 = time.perf_counter()
    summary = train_flow(config, device=device)
    elapsed = time.perf_counter() - t0
    final = summary.get("loss", {}).get("final")
    if final is None or not math.isfinite(final):
        return False, f"non-finite final loss {final}", elapsed
    return True, f"loss {final:.4f}", elapsed


def run(paths: list[Path], out_root: Path, device: str = "cuda"
        ) -> list[dict]:
    """Smoke every config; print one line each and the pass count."""
    results = []
    for i, path in enumerate(paths):
        try:
            ok, note, elapsed = smoke_one(path, out_root, device)
        except Exception as exc:
            ok, note, elapsed = False, f"{type(exc).__name__}: {exc}", 0.0
            traceback.print_exc()
        print(f"[{i + 1:2d}/{len(paths)}] {'PASS' if ok else 'FAIL'} "
              f"{path.stem} ({elapsed:5.1f}s) {note}", flush=True)
        results.append({"config": path.stem, "ok": ok, "note": note,
                        "seconds": round(elapsed, 1)})
    passed = sum(r["ok"] for r in results)
    print(f"\n{passed}/{len(paths)} configs train end-to-end", flush=True)
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Smoke-train every config")
    parser.add_argument("--configs", type=Path, default=Path("configs"))
    parser.add_argument("--out", type=Path,
                        default=Path("runs") / "matrix_smoke")
    parser.add_argument("--filter", type=str, default=None,
                        help="substring filter on config names")
    parser.add_argument("--report", type=Path, default=None,
                        help="write a JSON report here")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default the card)")
    args = parser.parse_args(argv)
    paths = sorted(args.configs.glob("*.json"))
    if args.filter:
        paths = [p for p in paths if args.filter in p.name]
    results = run(paths, args.out, args.device)
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(results, indent=2))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
