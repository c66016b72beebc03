"""The readers of the program's own spans: a traced run's profiled half
holds the program's spans and reports the five metrics that read them; its
first half and an untraced run hold none; a program without a span store
gives the readers nothing; the idle time splits by the program span open
at each gap."""

from __future__ import annotations

import math
import sys

import pytest

from meanflow_audio_codec_torch import tracing as store
from portbench import harness, program_spans
from portbench.tests import tiny

READS = {"corpus_v2.train": ["forward_ms_per_step.train", "backward_ms_per_step.train",
                             "update_ms_per_step.train"],
         "frontier_v2.roundtrip": ["flow_products_ms.serve", "flow_stages_ms.serve"]}


@pytest.fixture
def runs(monkeypatch):
    """The ``harness.Run`` of each run, kept as the readers get it."""
    kept, per_layer = [], harness.per_layer

    def keep(run, wanted):
        kept.append(run)
        return per_layer(run, wanted)

    monkeypatch.setattr(harness, "per_layer", keep)
    return kept


@pytest.mark.parametrize("workload", sorted(READS))
def test_a_traced_run_reads_the_program_spans_of_its_profiled_half(
        tmp_path, monkeypatch, runs, workload):
    root = tiny.tiny_tree(tmp_path)
    result, _ = tiny.run(monkeypatch, root, workload, trace=True)
    for name in READS[workload]:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0
    (run,) = runs
    trace = run.device_trace
    assert run.program_spans
    for s in run.program_spans:  # none from the first half
        assert trace.t0_ns <= s.start_ns <= s.end_ns <= trace.t1_ns
    idle = program_spans.idle_gaps_by_program_span(trace, run.program_spans)
    assert sum(v for _, v in idle) == pytest.approx(trace.window_s - trace.busy_s)
    if workload == "frontier_v2.roundtrip":  # the two split the flow's time
        found = run.program_spans
        flow = sum(s.device_ms for s in program_spans.named(found, "flow.forward"))
        sampler = sum(s.device_ms for s in program_spans.named(found, "codec.flow"))
        calls = len(program_spans.named(found, "codec.decode"))
        parts = calls * sum(result["metrics"][n]["value"] for n in READS[workload])
        assert parts == pytest.approx(flow) and parts <= sampler


def test_an_untraced_run_records_no_program_span(tmp_path, monkeypatch):
    store.collect()
    root = tiny.tiny_tree(tmp_path)
    tiny.run(monkeypatch, root, "frontier_v2.roundtrip")
    assert store.collect() == []


def test_a_program_without_a_span_store_leaves_the_readers_nothing(
        tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.STORE, None)
    root = tiny.tiny_tree(tmp_path)
    try:
        result, _ = tiny.run(monkeypatch, root, "corpus_v2.train", trace=True)
    finally:
        store.collect()  # what the program recorded, read by no reader
    assert not set(READS["corpus_v2.train"]) & set(result["metrics"])
    assert "mfu.train" in result["metrics"]
