"""The knee of an open-loop cell: its driver at a list of fixed rates, in
one process on the card, with set-up once. The workload is a cell of
``BENCHMARK.json`` whose traffic uses the ``open_loop_requests`` driver.

    python3 portbench/sweep.py --workload frontier_v2.decode_requests \
        --rates 20 25 30 35 --seconds 20 --seed 5

For each rate one window and its latencies: p50, p95 and p99, the mean
service time, the server's busy share, and how the backlog moved: the mean
latency of the last tenth of the requests over the first tenth's, and the
seconds the queue took to drain after the last arrival. The knee is the
highest rate whose backlog does not grow over the window. Not run by the
benchmark's command; PERF.md quotes its output where it sets a rate.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.drivers import open_loop_requests
    from portbench.work import PEAKS

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    found = harness.card(cell["chips"])
    if found is None:
        return 3
    device, kind = found
    config = harness.load_json(harness.BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    run = harness.Run(cell, config, traffic, args.seed, args.seconds, False, device,
                      PEAKS[kind])
    driver = open_loop_requests.Driver(run)
    driver.setup()
    sizes = driver.sizes
    for d in range(traffic["min_s"], traffic["max_s"] + 1):  # every duration
        driver._decode(0, sizes.frames(d * sizes.sample_rate)).cpu()
    for rate in args.rates:
        driver.rate = rate
        last_due = driver.schedule(args.seconds, driver.windows)[0][-1][0]
        w = driver.window(args.seconds)
        lat = w["latency_s"]
        q = statistics.quantiles(lat, n=100, method="inclusive")
        tenth = max(1, len(lat) // 10)
        print(json.dumps({
            "rate": rate, "requests": len(lat), "p50_ms": 1000 * q[49],
            "p95_ms": 1000 * q[94], "p99_ms": 1000 * q[98],
            "service_ms_mean": 1000 * statistics.mean(w["service_s"]),
            "busy_share": sum(w["service_s"]) / w["elapsed_s"],
            "backlog_growth": statistics.mean(lat[-tenth:]) / statistics.mean(lat[:tenth]),
            "drain_s": w["elapsed_s"] - last_due}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
