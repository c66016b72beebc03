"""The traffic generator repeats for a seed and differs across seeds; the
open-loop driver times requests from their due time; each driver's dry run
on the CPU at a tiny size gives a result line of the contract's shape."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import traffic_gen
from portbench.tests import tiny

WORKLOADS = ["frontier_v2.roundtrip", "corpus_v2.train"]


def test_clip_bank_repeats_for_a_seed_and_differs_across_seeds():
    a = traffic_gen.clip_bank(7, 3, 4000, 44100, "cpu")
    assert a.shape == (3, 4000, 2)
    assert torch.equal(a, traffic_gen.clip_bank(7, 3, 4000, 44100, "cpu"))
    assert not torch.equal(a, traffic_gen.clip_bank(8, 3, 4000, 44100, "cpu"))
    assert 0.05 < float(a.abs().max()) < 1.0


def test_large_seeds_work():
    big = 2 ** 31 + 12345
    assert traffic_gen.clip_bank(big, 1, 100, 44100, "cpu").shape == (1, 100, 2)
    assert len(traffic_gen.durations(big, 10, 8, 0.8, 1, 30)) == 10


def test_durations_are_whole_seconds_drawn_from_the_lognormal():
    a = traffic_gen.durations(3, 4000, 8, 0.8, 1, 30)
    assert a == traffic_gen.durations(3, 4000, 8, 0.8, 1, 30)
    assert a != traffic_gen.durations(4, 4000, 8, 0.8, 1, 30)
    assert all(isinstance(d, int) and 1 <= d <= 30 for d in a)
    assert 7 <= sorted(a)[2000] <= 9  # the median
    assert len(set(a)) <= 30
    # drawn one by one: a seed changes how much work a run holds
    assert sum(a[:400]) != sum(traffic_gen.durations(4, 400, 8, 0.8, 1, 30))


def test_arrivals_are_a_poisson_process():
    a = traffic_gen.arrivals(3, 50.0, 4000)
    assert a == traffic_gen.arrivals(3, 50.0, 4000)
    assert a != traffic_gen.arrivals(4, 50.0, 4000)
    gaps = [y - x for x, y in zip(a, a[1:])]
    assert a[0] == 0.0 and all(g >= 0 for g in gaps)
    mean = sum(gaps) / len(gaps)
    assert mean == pytest.approx(1 / 50.0, rel=0.05)
    # exponential gaps: their spread is their mean, and bursts come
    spread = (sum((g - mean) ** 2 for g in gaps) / len(gaps)) ** 0.5
    assert spread == pytest.approx(mean, rel=0.1)
    assert min(gaps) < 0.01 * mean


class SlowCodec:
    """Decodes take 30 ms: requests due together queue behind each other."""

    def decode(self, latents, gains=None, noise=None):
        time.sleep(0.03)
        return torch.zeros(1, 10, 2)


def test_the_open_loop_times_each_request_from_its_due_time(tmp_path, monkeypatch):
    from portbench import harness
    from portbench.drivers import open_loop_requests

    root = tiny.tiny_tree(tmp_path)
    monkeypatch.setattr(harness, "BENCH_DIR", root)
    cell = harness.find_cell(tiny.with_requests(root), tiny.REQUESTS_CELL)
    config = harness.load_json(root / "configs" / "frontier_v2.json")
    traffic = dict(tiny.REQUESTS, rate_per_s=1000.0)
    run = harness.Run(cell, config, traffic, 3, 0.005, False, torch.device("cpu"),
                      tiny.CPU_PEAKS)
    driver = open_loop_requests.Driver(run)
    driver.setup()
    driver.codec = SlowCodec()
    window = driver.window(0.005)
    latency, service = window["latency_s"], window["service_s"]
    assert len(latency) == 5
    # all five are due within 5 ms; the k-th waits for the k - 1 before it
    assert latency[-1] >= 5 * 0.03 - 0.005 - 1e-3
    assert all(lat >= s - 1e-3 for lat, s in zip(latency, service))
    assert max(service) < 0.06


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS + [tiny.REQUESTS_CELL])
def test_a_dry_run_prints_a_line_of_the_contracts_shape(tmp_path, monkeypatch, workload,
                                                       trace):
    root = tiny.tiny_tree(tmp_path)
    bench = tiny.with_requests(root)
    result, numbers = tiny.run(monkeypatch, root, workload, trace=trace, bench_json=bench)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    device = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    from portbench import harness

    wanted = harness.metrics_for(bench, cell, "per_layer" if trace else "end_to_end")
    names = {m["name"] for m in wanted}
    assert set(line["metrics"]) <= names
    for item in line["metrics"].values():
        assert set(item) == {"value", "unit"} and item["value"] == item["value"]
    if trace:
        assert device["busy_s"] > 0 and device["window_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            assert 0 < len(line["breakdown"][key]) <= 10
        # the readers that need no card kernel (the request cell has none yet)
        assert line["metrics"] or workload == tiny.REQUESTS_CELL
    else:
        assert set(line["metrics"]) == names
    for item in line["compared"].values():
        assert item["value"] <= item["limit"]
