"""The benchmark of meanflow_audio_codec_torch: one run of one cell.

    python3 portbench/run.py --workload frontier_v2.roundtrip --seed 7 \
        --seconds 20 --trace 0

runs on the card the cell asks for (and fails without one), prints
progress and the compared numbers on standard error, and as its last line
on standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then ``compared``,
each number held for ``correct`` with its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # kernel caches at fixed places inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    try:
        import meanflow_audio_codec_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program is missing: {exc}", file=sys.stderr)
        return 3
    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
