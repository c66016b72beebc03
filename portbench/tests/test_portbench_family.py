"""The model-family seam: the harness finds a configuration's reference by the
name of its architecture (``reference/family_<architecture>.py``).

- The ConvNeXt cells read what they read before the seam: the same weight
  draws, FLOP counts and compared numbers, taken from the benchmark before
  the seam at one CPU thread (the compared numbers are rounding gaps, and
  another thread count sums in another order).
- A second family, the program's ``mlp`` flow, goes in as new files alone:
  its reference module, a configuration without ``architecture_options``,
  ``lr_schedule`` or ``grad_clip_norm``, and limits; its train and round-trip
  cells then come out correct, and not correct with the timed path broken.
"""

from __future__ import annotations

import copy
import hashlib
import json

import pytest
import torch

from portbench import harness, program, work
from portbench.tests import tiny

DRAW_SEED = 2147485099
#: from the benchmark before the seam: sha256 over each drawn tensor's name,
#: shape and float32 bytes, in order
DRAWS = {"frontier_v2": "f224f2b9e35efebebd3df003e8d2529c8af74d339e7eaa1c949128ee464893fa",
         "corpus_v2": "957f97fc96f4064d1dafda2a37db989edc5120985b1b85b181dc2732f8a6ab01"}
#: (F_enc, F_dec) a row
FLOPS = {"frontier_v2": (1712128.0, 941752320.0), "corpus_v2": (1712128.0, 3728867328.0)}
#: tiny runs at seed 5, one window call or chunk, one thread
COMPARED = {
    "frontier_v2.roundtrip": {"audio_rel_l2": 2.2377358721785072e-07},
    "corpus_v2.train": {"feed_rows_from_bank": 0.0, "loss_gap": 5.771332145647042e-08,
                        "grad_norm_gap": 2.5540692167813272e-08, "change_gap": 0.0,
                        "leaves_left_out": 0.0},
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(name: str) -> dict:
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")["config"]


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_the_convnet_family_draws_and_counts_as_before(name):
    config = _config(name)
    family = harness.family(config)
    geo = family.Geometry.from_config(config)
    digest = hashlib.sha256()
    for n, v in family.draw(geo, DRAW_SEED, "cpu").items():
        digest.update(n.encode())
        digest.update(repr(tuple(v.shape)).encode())
        digest.update(v.numpy().tobytes())
    assert digest.hexdigest() == DRAWS[name]
    assert work.model_flops_per_row(family, geo) == FLOPS[name]


@pytest.mark.parametrize("workload", sorted(COMPARED))
def test_a_tiny_run_compares_what_it_compared_before(tmp_path, monkeypatch, one_thread,
                                                     workload):
    root = tiny.tiny_tree(tmp_path)
    _, numbers = tiny.run(monkeypatch, root, workload, seconds=0.0)
    assert numbers == COMPARED[workload]


#: the reference of the program's ``mlp`` family (``models/mlp_flow.py``),
#: as a later change would add it
FAMILY_MLP = '''"""The ``mlp`` family: an MLP encoder and ``ConditionalFlow``'s adaLN
residual blocks over [latent ++ x], each block scaled by 1 / num_blocks."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from portbench.reference import weights
from portbench.reference.layers import Ops, embedding, gelu, layer_norm

ROW_BLOCKS = {"encode": 4096, "decode": 4096, "loss": 256}


@dataclass(frozen=True)
class Geometry:
    noise_dim: int
    condition_dim: int
    latent_dim: int
    num_blocks: int

    @classmethod
    def from_config(cls, config):
        model, tok = config["model"], config["dataset"]["tokenization_config"]
        return cls(noise_dim=2 * tok["window_size"],
                   condition_dim=model["condition_dimension"],
                   latent_dim=model["latent_dimension"], num_blocks=model["num_blocks"])


def latent_shape(geo):
    return (geo.latent_dim,)


def _mlp(p, name, x, ops):
    h = gelu(ops.linear(x, p[name + ".fc1.weight"], p[name + ".fc1.bias"]))
    return ops.linear(h, p[name + ".fc2.weight"], p[name + ".fc2.bias"])


def encode(p, x, geo, ops=Ops()):
    return _mlp(p, "encoder.mlp", x.float(), ops)


def flow(p, x, time, latents, geo, ops=Ops()):
    cond = (embedding(time[:, 0], geo.condition_dim)
            + embedding(time[:, 1], geo.condition_dim))
    n, d = geo.noise_dim, geo.latent_dim + geo.noise_dim
    h = x.float()
    for i in range(geo.num_blocks):
        inp = torch.cat([latents.float(), h], dim=-1)
        mod = _mlp(p, f"blocks.{i}.modulation", cond, ops)
        scale1, shift, scale2 = mod.split((d, d, n), dim=-1)
        out = _mlp(p, f"blocks.{i}.mlp", (1.0 + scale1) * layer_norm(inp) + shift, ops)
        h = out * (1.0 + scale2) / geo.num_blocks + inp[:, -n:]
    return h


def shapes(geo):
    n, z, e = geo.noise_dim, geo.latent_dim, geo.condition_dim
    d, out = n + z, {}

    def mlp(name, fan_in, hidden, fan_out):
        out[name + ".fc1.weight"], out[name + ".fc1.bias"] = (hidden, fan_in), (hidden,)
        out[name + ".fc2.weight"], out[name + ".fc2.bias"] = (fan_out, hidden), (fan_out,)

    mlp("encoder.mlp", n, (n + z) // 2, z)
    for i in range(geo.num_blocks):
        mlp(f"blocks.{i}.modulation", e, e, 2 * d + n)
        mlp(f"blocks.{i}.mlp", d, d, n)
    return out


def _scale(name, shape):
    return 1.0 / math.sqrt(shape[1]) if name.endswith(".weight") else 0.02


def ref_name(port_name):
    return port_name


def draw(geo, seed, device):
    return weights.draw(shapes(geo), _scale, seed, device)


def to_port(params, port_names):
    return weights.to_port(params, port_names, ref_name)
'''


def _with_mlp_family(root) -> dict:
    """The mlp family, its tiny configuration and the limits of its two cells
    added under ``root`` as new files; ``BENCHMARK.json`` with new entries
    (the cells appended to the lists of the metrics they report)."""
    (root / "reference" / "family_mlp.py").write_text(FAMILY_MLP)
    config = json.loads((root / "configs" / "frontier_v2.json").read_text())
    model, base = config["config"]["model"], config["config"]["base"]
    model["architecture"] = "mlp"
    del model["architecture_options"]
    for key in ("lr_schedule", "lr_final_fraction", "grad_clip_norm", "warmup_steps"):
        del base[key]
    (root / "configs" / "mlp_tiny.json").write_text(json.dumps(config))
    (root / "limits" / "mlp_tiny.roundtrip.json").write_text(
        json.dumps({"limits": {"audio_rel_l2": 1e-3}}))
    (root / "limits" / "mlp_tiny.train.json").write_text(json.dumps(
        {"limits": {"feed_rows_from_bank": 0, "grad_norm_gap": 1e-3, "change_gap": 1e-3}}))
    bench = copy.deepcopy(tiny.bench())
    bench["configs"].append(dict(bench["configs"][0], name="mlp_tiny",
                                 file="portbench/configs/mlp_tiny.json"))
    for traffic, metric in (("roundtrip", "codec_audio_s_per_s"),
                            ("train", "train_frames_per_s")):
        cell = f"mlp_tiny.{traffic}"
        bench["workloads"].append({"name": cell, "config": "mlp_tiny", "traffic": traffic,
                                   "chips": 1, "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if metric in (m["name"], m.get("moves")):
                m["workloads"].append(cell)
    return bench


@pytest.mark.parametrize("workload,fault", [
    ("mlp_tiny.roundtrip", None),
    ("mlp_tiny.train", None),
    ("mlp_tiny.roundtrip", "output"),
    ("mlp_tiny.train", "unchanged"),
    ("mlp_tiny.train", "half"),
])
def test_a_second_family_is_new_files_alone(tmp_path, monkeypatch, workload, fault):
    root = tiny.tiny_tree(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = _with_mlp_family(root)
    if fault == "output":
        monkeypatch.setattr(program, "codec",
                            tiny.altered_codec(program.codec, tiny.one_sample_altered))
    elif fault is not None:
        step = {"unchanged": tiny.unchanged_step, "half": tiny.half_batch_step}[fault]
        monkeypatch.setattr(program.Trainer, "chunk", step(program.Trainer.chunk))
    result, numbers = tiny.run(monkeypatch, root, workload, trace=fault is None,
                               bench_json=bench)
    assert result["correct"] is (fault is None), numbers
    if fault is None:  # the MFU readers count the mlp family's own FLOPs
        mfu = "mfu.train" if workload.endswith("train") else "mfu.serve"
        assert result["metrics"][mfu]["value"] > 0
    for path, data in before.items():
        assert path.read_bytes() == data
