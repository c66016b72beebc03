"""The harness finds a configuration, a traffic mix, a limit file and a
per-layer metric by name in files of their own; ``BENCHMARK.json`` keeps
the contract's form; and a run whose timed path is broken underneath comes
out not correct."""

from __future__ import annotations

import copy
import json
import re

import pytest

from portbench import harness, program
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_files_alone_add_a_cell_a_mix_and_a_metric(tmp_path, monkeypatch):
    root = tiny.tiny_tree(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "dummy_cfg.json").write_text(
        (root / "configs" / "frontier_v2.json").read_text())
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"driver": "codec_closed_loop", "clips_per_call": 1, "clip_seconds": 1,
         "bank_calls": 1, "noise_draws": 1, "check_calls": 1}))
    (root / "limits" / "dummy_cfg.dummy_mix.json").write_text(
        json.dumps({"limits": {"audio_rel_l2": 1e-3}}))
    (root / "metrics" / "calls_seen.dummy.py").write_text(
        "def read(run):\n    return float(run.window['calls'])\n")
    bench = copy.deepcopy(tiny.bench())
    bench["configs"].append(dict(bench["configs"][0], name="dummy_cfg",
                                 file="portbench/configs/dummy_cfg.json"))
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("dummy_cfg.dummy_mix")
    bench["per_layer"].append({"name": "calls_seen.dummy", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "codec call", "moves": "codec_audio_s_per_s",
                               "workloads": ["dummy_cfg.dummy_mix"]})
    result, _ = tiny.run(monkeypatch, root, "dummy_cfg.dummy_mix", trace=True,
                         bench_json=bench)
    assert result["correct"] is True
    assert 0 < result["metrics"]["calls_seen.dummy"]["value"] < result["attempted"]
    for path, data in before.items():
        assert path.read_bytes() == data


def test_a_cell_without_limits_is_not_correct(tmp_path, monkeypatch):
    root = tiny.tiny_tree(tmp_path)
    (root / "limits" / "frontier_v2.roundtrip.json").unlink()
    result, _ = tiny.run(monkeypatch, root, "frontier_v2.roundtrip")
    assert result["correct"] is False


def test_benchmark_json_keeps_the_contracts_form():
    bench = tiny.bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (harness.ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
        stored = json.loads((harness.ROOT / c["file"]).read_text())
        assert stored["reduced"] == c["reduced"]
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
        used.add(w["config"])
    assert used == configs
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for cell in bench["workloads"]:
        reported = harness.metrics_for(bench, cell, "end_to_end")
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.metrics_for(bench, cell, "per_layer")
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("workload,change", [
    ("frontier_v2.roundtrip", tiny.one_sample_altered),
    ("frontier_v2.roundtrip", tiny.half_left_out),
    (tiny.REQUESTS_CELL, tiny.one_sample_altered),
], ids=["roundtrip-altered", "roundtrip-half", "requests-altered"])
def test_a_broken_codec_is_not_correct(tmp_path, monkeypatch, workload, change):
    root = tiny.tiny_tree(tmp_path)
    bench = tiny.with_requests(root)
    monkeypatch.setattr(program, "codec", tiny.altered_codec(program.codec, change))
    result, numbers = tiny.run(monkeypatch, root, workload, bench_json=bench)
    assert result["correct"] is False
    assert numbers["audio_rel_l2"] > 1e-3


@pytest.mark.parametrize("fault", [tiny.unchanged_step, tiny.half_batch_step],
                         ids=["unchanged", "half"])
def test_a_broken_train_step_is_not_correct(tmp_path, monkeypatch, fault):
    root = tiny.tiny_tree(tmp_path)
    monkeypatch.setattr(program.Trainer, "chunk", fault(program.Trainer.chunk))
    result, numbers = tiny.run(monkeypatch, root, "corpus_v2.train")
    assert result["correct"] is False
    assert max(numbers["grad_norm_gap"], numbers["change_gap"]) > 1e-3


@pytest.mark.parametrize("control", ["fp8", "half"])
def test_the_controls_read_far_off_on_the_cpu(tmp_path, monkeypatch, control):
    root = tiny.tiny_tree(tmp_path)
    _, numbers = tiny.run(monkeypatch, root, "corpus_v2.train", control=control)
    assert max(numbers["grad_norm_gap"], numbers["change_gap"]) > 1e-3
