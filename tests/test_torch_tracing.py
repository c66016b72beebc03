"""The span store (``tracing``): off, the sites record nothing and change no
number; on, a train chunk, a codec call and the flow hold the spans of
their layers, nested, numbered, counted and stamped on the clock
``torch.profiler`` stamps its events with; ``ProfilingTrainer`` and
``TraceCapture`` read them."""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from meanflow_audio_codec_torch import tracing
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.data.device_pool import DeviceReplayPool
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops.tokenize import create_tokenization_strategy
from meanflow_audio_codec_torch.training.adapter import adapter_from_config
from meanflow_audio_codec_torch.training.objectives import create_loss_strategy
from meanflow_audio_codec_torch.training.optim import TrainState, make_optimizer
from meanflow_audio_codec_torch.training.profiling import (
    ProfilingTrainer,
    TraceCapture,
)
from meanflow_audio_codec_torch.training.train_step import (
    make_multi_step,
    make_train_step,
)

ROOT = Path(__file__).resolve().parents[1]
STEP_PHASES = ["step.tokenize", "step.draws", "step.forward", "step.backward",
               "step.update"]
CLIPS, SAMPLES = 2, 256  # W 8, hop 4: 63 frames a clip
NUM_BLOCKS = 2


def _config():
    """frontier_v2's layout (lift and unlift convs, remat of the stage's
    elementwise segments) at 2 blocks of 8 channels on a 2 x 2 grid."""
    data = json.loads((ROOT / "configs" / "frontier_v2.json").read_text())
    data["model"].update(noise_dimension=16, condition_dimension=16,
                         latent_dimension=8, num_blocks=NUM_BLOCKS)
    data["model"]["architecture_options"].update(
        channels=8, bottleneck_dim=16, spatial=2, lift_channels=4)
    data["dataset"]["tokenization_config"].update(
        window_size=8, frame_size=SAMPLES, device_pool_clips=4)
    data["base"]["batch_size"] = CLIPS
    data["tpu"].update(precision="float32", steps_per_call=2)
    return config_from_dict(data)


CONFIG = _config()
ROWS = CLIPS * ((SAMPLES - 8) // 4 + 1)


@pytest.fixture(autouse=True)
def store():
    """A drained store that no ``on()`` holds, before and after."""
    tracing.collect()
    assert not tracing.ON
    yield
    tracing.collect()
    assert not tracing.ON


def _state(seed: int = 0) -> TrainState:
    torch.manual_seed(seed)
    return TrainState(create_flow_model(CONFIG), make_optimizer(CONFIG),
                      CONFIG.ema_decay, device="cpu")


def _adapter():
    return adapter_from_config(CONFIG, create_tokenization_strategy(
        CONFIG.tokenization_strategy, CONFIG.tokenization_config))


def _batches(k: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    return 0.3 * torch.randn((k, CLIPS, SAMPLES, 2), generator=gen)


def _chunk(state: TrainState, k: int = 2):
    run = make_multi_step(create_loss_strategy(CONFIG), k, _adapter(),
                          remat=True, skip_nonfinite=True)
    return run(state, _batches(k), torch.Generator().manual_seed(2))


def _codec() -> AudioCodec:
    torch.manual_seed(3)
    return AudioCodec(create_flow_model(CONFIG), None, CONFIG, device="cpu")


def _audio() -> torch.Tensor:
    return 0.3 * torch.randn((CLIPS, SAMPLES, 2),
                             generator=torch.Generator().manual_seed(4))


def _by_id(spans):
    return {s.id: s for s in spans}


def _inside(child, parent) -> bool:
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_off_a_chunk_records_nothing_and_tracing_changes_no_number():
    assert tracing.span("product") is tracing.span("flow.forward")
    state_off, series_off = _chunk(_state())
    assert tracing.collect() == []
    tracing.on()
    try:
        state_on, series_on = _chunk(_state())
    finally:
        tracing.off()
    assert tracing.collect()
    for a, b in zip(state_off.params + state_off.mu + state_off.ema,
                    state_on.params + state_on.mu + state_on.ema):
        assert torch.equal(a, b)
    for name in series_off:
        assert torch.equal(series_off[name], series_on[name])


@pytest.mark.parametrize("steps", [1, 2], ids=["train_step", "multi_step"])
def test_a_chunk_nests_its_steps_and_their_phases(steps):
    tracing.on()
    try:
        if steps == 1:
            make_train_step(create_loss_strategy(CONFIG), _adapter(),
                            remat=True, skip_nonfinite=True)(
                _state(), _batches(1)[0], torch.Generator().manual_seed(2))
        else:
            _chunk(_state(), steps)
    finally:
        tracing.off()
    spans = tracing.collect()
    ids = _by_id(spans)
    (chunk,) = [s for s in spans if s.name == "train.chunk"]
    assert chunk.parent is None and chunk.request == 0
    step_spans = [s for s in spans if s.name == "step"]
    assert [s.request for s in step_spans] == list(range(steps))
    for step in step_spans:
        assert step.parent == chunk.id and _inside(step, chunk)
        assert step.counts == {"rows": ROWS}
        phases = [s for s in spans if s.parent == step.id]
        assert [s.name for s in phases] == STEP_PHASES
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns <= b.start_ns
        for s in phases:
            assert _inside(s, step) and s.request == step.request
    # a chunk records its steps' phases, not the model's inner spans
    assert {s.name for s in spans} == {"train.chunk", "step", *STEP_PHASES}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert _inside(s, ids[s.parent])
        assert s.device_ms >= 0 and s.self_ms >= 0


def test_a_codec_call_holds_its_layers_and_one_product_span_per_product():
    codec = _codec()
    tracing.on()
    try:
        codec.roundtrip(_audio())
    finally:
        tracing.off()
    spans = tracing.collect()
    ids = _by_id(spans)
    children = {s.id: [c.name for c in spans if c.parent == s.id] for s in spans}
    (encode,) = [s for s in spans if s.name == "codec.encode"]
    (decode,) = [s for s in spans if s.name == "codec.decode"]
    assert encode.request == decode.request == 0
    assert encode.parent is decode.parent is None
    assert encode.counts == decode.counts == {"rows": ROWS}
    assert children[encode.id] == ["codec.tokenize", "codec.encoder"]
    assert children[decode.id] == ["codec.flow", "codec.detokenize"]
    (flow,) = [s for s in spans if s.name == "flow.forward"]
    assert ids[flow.parent].name == "codec.flow"
    # ten products a stage (bottleneck in, lift, lift conv, FiLM, the
    # block's 3x3 conv, expand and contract, unlift conv, bottleneck out,
    # out) and the latent projection
    assert children[flow.id] == ["product"] * (10 * NUM_BLOCKS + 1)
    assert all(s.self_ms >= 0 for s in spans)
    stages = flow.device_ms - sum(s.device_ms for s in spans
                                  if s.parent == flow.id)
    assert flow.self_ms == pytest.approx(stages)


def test_a_second_call_is_numbered_and_a_profiler_turns_the_store_on():
    codec, audio = _codec(), _audio()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        codec.roundtrip(audio)
        codec.roundtrip(audio)
    spans = tracing.collect()
    assert [s.request for s in spans if s.name == "codec.decode"] == [0, 1]
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    # each product span holds the profiler's record of its product, and
    # each span the start of some operation the profiler saw
    ops = [(a, b) for name, a, b in events
           if name in ("aten::linear", "aten::conv2d")]
    for s in spans:
        assert any(s.start_ns <= a <= s.end_ns for _, a, _ in events)
        if s.name == "product":
            assert any(s.start_ns <= a <= b <= s.end_ns for a, b in ops)


def _on_a_thread() -> int:
    """Opens a span on a new thread; the thread's native id."""
    found = {}

    def worker():
        with tracing.span("inner"):
            found["thread"] = threading.get_native_id()

    thread = threading.Thread(target=worker)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()
    return found["thread"]


def test_a_span_on_another_thread_has_no_parent():
    tracing.on()
    try:
        with tracing.span("outer"):
            thread = _on_a_thread()
        # under a root that bounds its depth, only the root's thread records
        with tracing.root("bounded", depth=2):
            _on_a_thread()
    finally:
        tracing.off()
    outer, inner, bounded = sorted(
        tracing.collect(), key=lambda s: ["outer", "inner", "bounded"].index(s.name))
    assert inner.parent is None and inner.thread == thread
    assert outer.thread == bounded.thread == threading.get_native_id() != thread


def test_the_pool_records_host_spans_and_skipped_refreshes():
    gate = threading.Event()

    def source():  # two batches fill the pool, the producer queues a third
        for _ in range(3):
            yield np.zeros((2, 64, 2), np.float32)
        gate.wait(timeout=30)

    pool = DeviceReplayPool(source(), pool_clips=4, seed=0, device="cpu")
    tracing.on()
    try:
        pool.sample(2, 2)
        pool.refresh(wait=True)
        pool.refresh()  # the producer waits on the gate: skipped
    finally:
        tracing.off()
        gate.set()
        pool.close()
    spans = tracing.collect()
    assert [s.name for s in spans] == ["pool.sample"] + ["pool.refresh"] * 2
    assert [s.counts.get("skipped") for s in spans[1:]] == [0, 1]
    assert all(s.device_ms is None and s.parent is None for s in spans)


def test_profiling_trainer_reads_the_chunk_span():
    profiler = ProfilingTrainer(flops_per_step=1e9, device="cpu")
    state = _state()
    profiler.before_step()
    _chunk(state)
    record = profiler.after_step(1)
    assert not tracing.ON
    assert record["step_time"] > 0 and record["avg_step_time"] > 0
    assert "mfu" not in record  # no peak on the CPU
    phases = profiler.end_training(2)["phase_ms"]
    assert sorted(phases) == sorted(p[5:] for p in STEP_PHASES)
    assert 0 < sum(phases.values()) * 2 <= 1e3 * record["step_time"]
    profiler.before_step()
    with pytest.raises(RuntimeError, match="train.chunk"):
        profiler.after_step(2)
    assert not tracing.ON


def test_trace_capture_writes_the_program_spans(tmp_path):
    codec = _codec()
    with TraceCapture(tmp_path) as capture:
        assert tracing.ON
        codec.roundtrip(_audio())
    assert not tracing.ON
    trace = json.loads(capture.path.read_text())["traceEvents"]
    spans = [e for e in trace if e.get("cat") == "program_span"]
    names = {e["name"] for e in spans}
    assert {"codec.encode", "codec.decode", "flow.forward", "product"} <= names
    ops = [e for e in trace if e.get("name") == "aten::linear"]
    (decode,) = [e for e in spans if e["name"] == "codec.decode"]
    assert decode["args"]["rows"] == ROWS and decode["args"]["device_ms"] > 0
    inside = [e for e in ops
              if decode["ts"] <= e["ts"] <= decode["ts"] + decode["dur"]]
    assert inside and decode["tid"] == inside[0]["tid"]


def test_a_collect_hands_each_span_out_once_and_feeds_every_kept_list():
    kept = []
    tracing.on(kept)
    try:
        with tracing.span("a"):
            pass
        first = tracing.collect()
        with tracing.span("b"):
            pass
        second = tracing.collect()
    finally:
        tracing.off(kept)
    tracing.on()
    try:
        with tracing.span("c"):
            pass
    finally:
        tracing.off()
    assert [s.name for s in tracing.collect()] == ["c"]
    assert [s.name for s in first] == ["a"]
    assert [s.name for s in second] == ["b"]
    assert [s.name for s in kept] == ["a", "b"]

