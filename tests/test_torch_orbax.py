"""PyTorch port: orbax checkpoints (``training/orbax``, the orbax path of
``training/checkpoints.py``) against orbax, tensorstore and the JAX
package.

What is compared, and with what tolerance:
  * the port's OCDBT reader against tensorstore on JAX-written directories
    (train states with and without EMA, with and without the clip chain, a
    learned-weighting run, a bf16 leaf, multi-block values): the same keys
    and the same bytes under each;
  * directories written by either package: restored by the other's
    loaders, every leaf equal bit for bit, the ``_METADATA`` tree equal to
    JAX's for the same state; tensorstore reads every key the port wrote;
  * runs: each package's trainer resumes the other's orbax run (2 steps
    each), and the served round trip of an orbax run matches JAX's codec
    at float32 rtol/atol 1e-4 (the codec tolerance of
    tests/test_torch_serving.py);
  * the committed JAX-written fixture (tests/make_torch_orbax_fixture.py)
    reads equal to orbax's restore of it and to its msgpack twin.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from flax import serialization as fs

from meanflow_audio_codec_tpu.codec import AudioCodec as JaxAudioCodec
from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.training import checkpoints as jckpt
from meanflow_audio_codec_tpu.training.trainer import (
    train_flow as jax_train_flow,
)
from meanflow_audio_codec_torch import serialization, weights
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import config_from_dict, load_config
from meanflow_audio_codec_torch.training import checkpoints
from meanflow_audio_codec_torch.training.logging import read_log
from meanflow_audio_codec_torch.training.orbax import ocdbt, pytree
from meanflow_audio_codec_torch.training.trainer import (
    load_flow_state,
    train_flow,
)
from test_torch_checkpoints import (
    _assert_trees_equal,
    _jax_config,
    _jax_template,
    _port_state,
)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_orbax_run"

RUN = {
    "config_version": "2.0",
    "base": {"batch_size": 2, "n_steps": 2, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3, "grad_clip_norm": 1.0},
    "model": {"noise_dimension": 64, "condition_dimension": 8,
              "latent_dimension": 8, "num_blocks": 1,
              "architecture": "convnet",
              "architecture_options": {"channels": 8, "bottleneck_dim": 16,
                                       "spatial": 4, "lift_channels": 4}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {
                    "frame_size": 1024, "window_size": 32,
                    "coeff_scale": 4.0, "gain_norm": 0.05,
                    "device_pool_clips": 4, "synthetic_family": "mixed"}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True,
               "loss_weighting": "learned"},
    "training": {"sample_every": 1000, "sample_seed": 1, "sample_steps": 1,
                 "workdir": "unset", "checkpoint_step": 2,
                 "max_checkpoints_to_keep": 2, "ema_decay": 0.99,
                 "checkpoint_format": "orbax"},
    "tpu": {"precision": "float32", "steps_per_call": 2,
            "skip_nonfinite_updates": True},
}
TOL = dict(rtol=1e-4, atol=1e-4)


def _run(workdir, n_steps):
    data = json.loads(json.dumps(RUN))
    data["training"]["workdir"] = str(workdir)
    data["base"]["n_steps"] = n_steps
    return data


def _orbax_restore(path):
    with ocp.PyTreeCheckpointer() as checkpointer:
        return checkpointer.restore(path.absolute())


def _np_leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


def _same_keys_and_bytes(path):
    """The port's reader and tensorstore list the same keys of ``path``
    and read the same bytes under each; returns the key count."""
    store = ts.KvStore.open({"driver": "ocdbt",
                             "base": f"file://{path.absolute()}"}).result()
    keys = store.list().result()
    db = ocdbt.Database(path)
    assert db.keys() == sorted(keys)
    for key in keys:
        assert db.read(key) == store.read(key).result().value, key
    return len(keys)


def _jax_state(ema=True, clip=True):
    jcfg = _jax_config(clip=clip, ema=ema)
    template = _jax_template(jcfg, ema)
    rng = np.random.default_rng(2)
    state = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)).astype(np.float32)
                   if isinstance(a, jax.Array) and a.dtype == jnp.float32
                   else a), template)
    return state.replace(step=jnp.asarray(7, jnp.int32))


# ---------------------------------------------------------------------------
# runs: a port run resumed by JAX's trainer, and that JAX-written run
# resumed by the port's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``port``: the port's 2-step orbax run; ``jax``: a copy that JAX's
    trainer resumed to step 4 (its step_00004.orbax written by JAX)."""
    root = tmp_path_factory.mktemp("orbax_runs")
    train_flow(config_from_dict(_run(root / "port", 2)), device="cpu")
    shutil.copytree(root / "port", root / "jax")
    jax_train_flow(TrainFlowConfig.from_dict(_run(root / "jax", 4)),
                   resume=True)
    return {"port": root / "port", "jax": root / "jax"}


def _starts(workdir):
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    return records, starts


def test_jax_trainer_resumes_a_port_orbax_run(runs):
    records, starts = _starts(runs["jax"])
    assert len(starts) == 2
    assert [r["step"] for r in records[starts[1] + 1:]
            if "event" not in r] == [2, 3]
    names = sorted(p.name for p in (runs["jax"] / "checkpoints").iterdir())
    assert "step_00004.orbax" in names and "step_00002.orbax" in names
    assert json.loads((runs["jax"] / "checkpoints" /
                       "step_00004.metadata.json").read_text())[
        "format"] == "orbax"


def test_port_trainer_resumes_a_jax_orbax_run(runs, tmp_path):
    workdir = tmp_path / "resumed"
    shutil.copytree(runs["jax"], workdir)
    written = workdir / "checkpoints" / "step_00004.orbax"
    config = config_from_dict(_run(workdir, 6))
    state, _ = load_flow_state(written, config, device="cpu")
    want = _orbax_restore(written)
    assert state.step == 4
    poly = dict(zip(state.names, state.params))["loss_weighting.poly"]
    np.testing.assert_array_equal(
        poly.detach().numpy(), want["params"]["loss_weighting"]["poly"])
    train_flow(config, resume=True, device="cpu")
    records, starts = _starts(workdir)
    assert [r["step"] for r in records[starts[-1] + 1:]
            if "event" not in r] == [4, 5]
    assert (workdir / "checkpoints" / "step_00006.orbax").is_dir()
    # retention (max 2) took step 2's directory and its sidecar
    assert sorted(p.name for p in (workdir / "checkpoints").glob(
        "step_*")) == ["step_00004.metadata.json", "step_00004.orbax",
                       "step_00006.metadata.json", "step_00006.orbax"]


def test_reader_matches_tensorstore_on_a_jax_trained_run(runs):
    """JAX's trainer wrote this directory (learned weighting, clip chain,
    EMA) through orbax's per-process database, merged at the root."""
    path = runs["jax"] / "checkpoints" / "step_00004.orbax"
    assert (path / "ocdbt.process_0").is_dir()
    assert _same_keys_and_bytes(path) > 100


def test_served_orbax_run_matches_jax_codec(runs):
    jcodec = JaxAudioCodec.from_workdir(runs["jax"])
    codec = AudioCodec.from_workdir(runs["jax"], device="cpu")
    rng = np.random.default_rng(1)
    audio = (0.2 * rng.standard_normal((2, 1024, 2))).astype(np.float32)
    nf = (1024 - 32) // 16 + 1
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, (2 * nf, 64)))
    ref = np.asarray(jcodec.roundtrip(audio, key=key))
    got = codec.roundtrip(audio, noise=noise).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------------------------
# train states written by one package, read by the other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ema,clip", [(True, True), (False, True),
                                      (True, False)],
                         ids=["clip-ema", "no-ema", "no-clip"])
def test_port_restores_a_jax_orbax_state(tmp_path, ema, clip):
    jstate = _jax_state(ema, clip)
    path = jckpt.save_checkpoint_orbax(jstate, tmp_path / "step_00007.orbax")
    assert _same_keys_and_bytes(path) > 100
    assert checkpoints.orbax_checkpoint_has_ema(path) == ema
    state = _port_state(clip, ema, seed=9)
    checkpoints.load_checkpoint_orbax(path, state)
    assert state.step == 7
    want = jax.tree_util.tree_map(np.asarray, fs.to_state_dict(jstate))
    want["ema_decay"] = np.asarray(state.ema_decay or 0.999, np.float32)
    # the optax counts of JAX's fresh template are 0; the port writes its
    # own count there (JAX's trainer keeps them equal to step)
    (want["opt_state"]["1"] if clip else want["opt_state"])["0"][
        "count"] = np.asarray(7, np.int32)
    _assert_trees_equal(weights.train_state_to_flax(state), want)


@pytest.mark.parametrize("ema,clip,schedule", [
    (True, True, False), (False, True, False), (True, False, True)],
    ids=["clip-ema", "no-ema", "no-clip-cosine"])
def test_jax_restores_a_port_orbax_state(tmp_path, ema, clip, schedule):
    state = _port_state(clip, ema, schedule=schedule)
    path = checkpoints.save_checkpoint_orbax(state,
                                             tmp_path / "step_00005.orbax")
    assert _same_keys_and_bytes(path) > 100
    assert jckpt.orbax_checkpoint_has_ema(path) == ema
    jcfg = _jax_config(clip=clip, ema=ema, schedule=schedule)
    jstate = jckpt.load_checkpoint_orbax(path, _jax_template(jcfg, ema))
    got = jax.tree_util.tree_map(np.asarray, fs.to_state_dict(jstate))
    want = weights.train_state_to_flax(state)
    got["ema_decay"] = want["ema_decay"]  # JAX keeps its template's
    _assert_trees_equal(got, want)
    # the same tree orbax writes: _METADATA equal to JAX's own directory
    jpath = jckpt.save_checkpoint_orbax(jstate, tmp_path / "jax.orbax")
    ours = json.loads((path / "_METADATA").read_text())
    theirs = json.loads((jpath / "_METADATA").read_text())
    assert ours == theirs
    assert list(ours["tree_metadata"]) == list(theirs["tree_metadata"])
    assert json.loads((path / "_CHECKPOINT_METADATA").read_text()).keys() \
        == json.loads((jpath / "_CHECKPOINT_METADATA").read_text()).keys()


def test_trees_of_every_leaf_kind_cross_both_ways(tmp_path):
    """Scalars, None, empty containers, a bf16 leaf, integer and bool
    arrays, and a 2.4 MB value in multi-block frames: orbax writes, the
    port reads; the port writes, orbax and tensorstore read."""
    rng = np.random.default_rng(0)
    big = rng.standard_normal((1024, 600)).astype(np.float32)
    half = np.asarray(jnp.asarray(rng.standard_normal((3, 5)),
                                  jnp.bfloat16))
    tree = {"a": 3, "b": 0.5, "none": None, "empty": {}, "nothing": [],
            "half": half, "big": big, "nest": [np.arange(5, dtype=np.int64),
                                                (np.ones(2, bool),)],
            "i": np.arange(6, dtype=np.int32).reshape(2, 3),
            "u": np.arange(3, dtype=np.uint32), "d": np.arange(3.0)}
    with ocp.PyTreeCheckpointer() as checkpointer:
        checkpointer.save((tmp_path / "orbax").absolute(), tree)
    assert _same_keys_and_bytes(tmp_path / "orbax") > 10
    back = pytree.restore_pytree(tmp_path / "orbax")
    assert back["a"] == 3 and back["b"] == 0.5 and back["none"] is None
    assert back["empty"] == {} and back["nothing"] == []
    assert back["half"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["half"].view(torch.int16).numpy(),
                                  half.view(np.int16))
    np.testing.assert_array_equal(back["big"].numpy(), big)
    np.testing.assert_array_equal(back["nest"][0].numpy(), tree["nest"][0])
    np.testing.assert_array_equal(back["nest"][1][0].numpy(), [True, True])
    np.testing.assert_array_equal(back["u"].numpy(), [0, 1, 2])

    ours = pytree.save_pytree(tmp_path / "port", back)
    assert _same_keys_and_bytes(ours) > 10
    assert json.loads((ours / "_METADATA").read_text())["tree_metadata"] \
        == json.loads((tmp_path / "orbax" / "_METADATA").read_text())[
            "tree_metadata"]
    again = _orbax_restore(ours)
    np.testing.assert_array_equal(again["big"], big)
    np.testing.assert_array_equal(again["half"].view(np.int16),
                                  half.view(np.int16))
    assert again["a"] == 3 and again["none"] is None
    assert pytree.pytree_metadata(ours)["half"] == "np.ndarray"


def test_interior_nodes_split_by_the_node_limit(tmp_path):
    """A node limit of 300 bytes splits the port's tree into leaves under
    interior nodes; tensorstore reads every key back."""
    values = {f"key{i:03d}/abc".encode(): bytes([i]) * (i % 50 + 1)
              for i in range(200)}
    writer = ocdbt.Writer(tmp_path, max_inline_value_bytes=20,
                          max_decoded_node_bytes=300)
    for key, value in values.items():
        writer.put(key, value)
    writer.commit()
    _same_keys_and_bytes(tmp_path)
    db = ocdbt.Database(tmp_path)
    assert {k: db.read(k) for k in db.keys()} == values


# ---------------------------------------------------------------------------
# faults, retention and the committed fixture
# ---------------------------------------------------------------------------


def test_resume_falls_back_from_a_truncated_data_file(tmp_path, capsys):
    good = _port_state()
    checkpoints.save_checkpoint_with_metadata(good, tmp_path, step=3,
                                              fmt="orbax")
    newest = checkpoints.save_checkpoint_with_metadata(
        _port_state(seed=5), tmp_path, step=6, fmt="orbax")
    data = max((newest / "d").iterdir(), key=lambda p: p.stat().st_size)
    data.write_bytes(data.read_bytes()[:-1000])
    with pytest.raises(ValueError):
        checkpoints.load_checkpoint_orbax(newest, _port_state())
    target = _port_state(seed=7)
    restored, step = checkpoints.load_checkpoint_and_resume(tmp_path, target)
    assert step == 3 and restored is target
    _assert_trees_equal(weights.train_state_to_flax(target),
                        weights.train_state_to_flax(good))
    assert "Skipping invalid checkpoint step_00006.orbax" in \
        capsys.readouterr().out
    # JAX's resume takes the same fallback on the same directory
    jcfg = _jax_config()
    jstate, jstep = jckpt.load_checkpoint_and_resume(tmp_path,
                                                     _jax_template(jcfg))
    assert jstep == 3 and int(jstate.step) == 5


def test_retention_removes_directories_and_sidecars(tmp_path):
    state = _port_state()
    for step in (2, 4, 6):
        checkpoints.save_checkpoint_with_metadata(state, tmp_path, step=step,
                                                  fmt="orbax")
    checkpoints.save_checkpoint_with_metadata(state, tmp_path, step=8)
    assert [p.name for p in checkpoints.list_checkpoints(tmp_path)] == [
        "step_00002.orbax", "step_00004.orbax", "step_00006.orbax",
        "step_00008.msgpack"]
    deleted = checkpoints.cleanup_old_checkpoints(tmp_path, 2, final_step=2)
    assert [p.name for p in deleted] == ["step_00004.orbax",
                                         "step_00006.orbax"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00002.metadata.json", "step_00002.orbax",
        "step_00008.metadata.json", "step_00008.msgpack"]
    assert checkpoints.find_latest_checkpoint(tmp_path).name == \
        "step_00008.msgpack"


def test_committed_fixture_reads_as_orbax_and_its_twin(tmp_path):
    path = checkpoints.find_latest_checkpoint(FIXTURE / "checkpoints")
    assert path.name == "step_00003.orbax"
    assert _same_keys_and_bytes(path) > 100
    want = _orbax_restore(path)
    got = pytree.restore_pytree(path)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda _: 0, got)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, want))
    for a, b in zip(_np_leaves(got), _np_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    config = load_config(FIXTURE / "config.json")
    ours, _ = load_flow_state(path, config, device="cpu")
    twin, _ = load_flow_state(FIXTURE / "twin" / "step_00003.msgpack",
                              config, device="cpu")
    tree = weights.train_state_to_flax(ours)
    tree["ema_decay"] = weights.train_state_to_flax(twin)["ema_decay"]
    _assert_trees_equal(tree, weights.train_state_to_flax(twin))
    assert serialization.msgpack_restore(
        (FIXTURE / "twin" / "step_00003.msgpack").read_bytes())["step"] == 3


def test_export_serving_takes_an_orbax_run(tmp_path):
    """``tools/export_serving`` finds the fixture's orbax directory through
    ``find_latest_checkpoint`` and writes its EMA as the serving file,
    which JAX's loader reads back equal to orbax's restore."""
    from meanflow_audio_codec_torch.tools import export_serving

    workdir = tmp_path / "run"
    shutil.copytree(FIXTURE, workdir)
    assert export_serving.main(["--workdir", str(workdir)]) == 0
    serving = workdir / "checkpoints" / "serving_step_00003.msgpack"
    want = _orbax_restore(workdir / "checkpoints" / "step_00003.orbax")
    step, params = jckpt.load_serving_checkpoint(serving,
                                                 want["ema_params"])
    assert step == 3
    for a, b in zip(_np_leaves(params), _np_leaves(want["ema_params"])):
        np.testing.assert_array_equal(a, b)


def test_zarr_reads_chunk_grids_fill_values_and_refuses_the_unknown(
        tmp_path):
    """An array tensorstore wrote in 4 x 3 chunks (level-3 zstd), some never
    written, reads back as tensorstore reads it, the missing chunks as the
    fill value; an unknown compressor or filter raises."""
    from meanflow_audio_codec_torch.training.orbax import zarr

    array = ts.open({
        "driver": "zarr", "path": "grid",
        "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/db"},
        "metadata": {"shape": [10, 7], "chunks": [4, 3], "dtype": "<f4",
                     "compressor": {"id": "zstd", "level": 3},
                     "fill_value": 1.5}}, create=True).result()
    values = np.arange(70, dtype=np.float32).reshape(10, 7)
    array[:6, :5].write(values[:6, :5]).result()
    want = array.read().result()
    assert (want == 1.5).any()
    got = zarr.read_array(ocdbt.Database(tmp_path / "db"), "grid")
    np.testing.assert_array_equal(got.numpy(), want)

    writer = ocdbt.Writer(tmp_path / "bad")
    for name, meta in (("blosc", {"compressor": {"id": "blosc"}}),
                       ("filtered", {"filters": [{"id": "delta"}]})):
        description = json.loads(zarr.description((2,), "<f4"))
        description.update(meta)
        writer.put(f"{name}/.zarray".encode(),
                   json.dumps(description).encode())
    writer.commit()
    db = ocdbt.Database(tmp_path / "bad")
    for name in ("blosc", "filtered"):
        with pytest.raises(ValueError, match="unknown"):
            zarr.read_array(db, name)
