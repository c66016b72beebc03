"""A copy of the benchmark's data files at a tiny size, for CPU tests: the
configurations cut to 2 blocks of 8 channels on a 2 x 2 grid with W 8, the
mixes to a few short clips."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench import harness

BENCH = harness.BENCH_DIR
CPU_PEAKS = {"bf16": 1e12, "f32": 1e11, "hbm": 1e11}


def tiny_config(config: dict) -> dict:
    cfg = config["config"]
    cfg["model"].update(condition_dimension=16, latent_dimension=8, num_blocks=2,
                        noise_dimension=16)
    cfg["model"]["architecture_options"].update(channels=8, bottleneck_dim=16,
                                                spatial=2, lift_channels=4)
    tok = cfg["dataset"]["tokenization_config"]
    tok.update(window_size=8, frame_size=256, device_pool_clips=8)
    cfg["base"]["batch_size"] = 2
    cfg["tpu"].update(precision="float32", steps_per_call=2)
    config["sample_rate"] = 400
    return config


TRAFFIC = {"roundtrip": {"clips_per_call": 2, "clip_seconds": 1, "bank_calls": 2},
           "train": {"bank_clips": 8}}
#: an open-loop mix of decode requests, which no cell of ``BENCHMARK.json``
#: runs yet: the tests add its cell as a later PR would
REQUESTS = {"driver": "open_loop_requests", "rate_per_s": 20.0, "median_s": 8,
            "sigma": 0.8, "min_s": 1, "max_s": 3, "check_requests": 3}
REQUESTS_CELL = "frontier_v2.decode_requests"


def tiny_tree(tmp: Path, limits: float = 1e-3) -> Path:
    """A tiny copy of the benchmark's data files under ``tmp``; every
    compared number held to ``limits``."""
    root = tmp / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in (root / "configs").glob("*.json"):
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    for name, change in TRAFFIC.items():
        path = root / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    for path in (root / "limits").glob("*.json"):
        data = json.loads(path.read_text())
        data["limits"] = {k: (0.0 if v == 0 else limits) for k, v in data["limits"].items()}
        path.write_text(json.dumps(data))
    return root


def bench() -> dict:
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def with_requests(root: Path, limit: float = 1e-3) -> dict:
    """``BENCHMARK.json`` with a request cell added, as new files under
    ``root`` and new entries."""
    (root / "traffic" / "decode_requests.json").write_text(json.dumps(REQUESTS))
    (root / "limits" / f"{REQUESTS_CELL}.json").write_text(
        json.dumps({"limits": {"audio_rel_l2": limit}}))
    out = bench()
    out["workloads"].append({"name": REQUESTS_CELL, "config": "frontier_v2",
                             "traffic": "decode_requests", "chips": 1, "why": "a test"})
    out["end_to_end"].append({"name": "request_ms_p95", "unit": "ms", "better": "lower",
                              "bound": 0.25, "source": "host_clock",
                              "workloads": [REQUESTS_CELL]})
    return out


def run(monkeypatch, root: Path, workload: str, seed: int = 5, seconds: float = 0.2,
        trace: bool = False, control=None, bench_json: dict | None = None):
    """``harness.execute`` of ``workload`` on the CPU over the tree ``root``."""
    monkeypatch.setattr(harness, "BENCH_DIR", root)
    return harness.execute(bench_json or bench(), workload, seed, seconds, trace,
                           0.0, torch.device("cpu"), "cpu", CPU_PEAKS, control)


# faults planted under the timed path: each must make a run not correct


def altered_codec(codec_fn, change):
    """``program.codec`` whose codec's outputs pass through ``change``."""

    def build(*args, **kwargs):
        codec = codec_fn(*args, **kwargs)
        roundtrip, decode = codec.roundtrip, codec.decode
        codec.roundtrip = lambda *a, **k: change(roundtrip(*a, **k))
        codec.decode = lambda *a, **k: change(decode(*a, **k))
        return codec

    return build


def one_sample_altered(out):
    """Two samples of the first clip moved by half the peak."""
    out = out.clone()
    out[0, 3:5, 0] += 0.5 * out.abs().max()
    return out


def half_left_out(out):
    """The second half of the clips left out (zeros)."""
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out if out.shape[0] > 1 else out * 0


def unchanged_step(chunk):
    """``Trainer.chunk`` whose steps return the state unchanged."""
    def make(self, k):
        def run(state, batches, generator=None, **draws):
            loss = torch.ones(k)
            return state, {"loss": loss, "grad_norm": loss, "mse": loss,
                           "update_ok": torch.ones(k, dtype=torch.bool)}
        return run
    return make


def half_batch_step(chunk):
    """``Trainer.chunk`` whose steps train on half of each batch."""
    def make(self, k):
        full = chunk(self, k)

        def run(state, batches, generator=None, **draws):
            half = batches.shape[1] // 2
            rows = {n: d[:, :d.shape[1] // 2] for n, d in draws.items()}
            return full(state, batches[:, :half], generator, **rows)
        return run
    return make
