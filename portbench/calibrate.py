"""Readings a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload frontier_v2.train \
        --seeds 11 12 13 --controls fp8 half --control-seeds 21 22 23 \
        --seconds 1 --out chiprun_out/calibrate.json

For each program seed, one run of the cell (a short window) and the
numbers its check reads; then, for each control seed, the same with the
control in the program's place:

- ``fp8`` (training cells): the reference with float8 e4m3 products;
- ``int8``: the program's own W8A8 int8 decoder (serving cells);
- ``half`` (training cells): the reference over half of each batch's
  clips, the mean taken over the rest.

Not run by the benchmark's command; its output is what PERF.md quotes for
each limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.work import PEAKS

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = harness.card(harness.find_cell(bench, args.workload)["chips"])
    if found is None:
        return 3
    device, kind = found
    rows = []
    plan = [(None, s) for s in args.seeds] + [
        (c, s) for c in args.controls for s in args.control_seeds]
    for control, seed in plan:
        t0 = time.perf_counter()
        result, numbers = harness.execute(
            bench, args.workload, seed, args.seconds, False, t0, device, kind,
            PEAKS[kind], control=control)
        row = {"control": control, "seed": seed, "numbers": numbers,
               "metrics": result["metrics"], "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
