"""PyTorch port: flax's msgpack format, the parameter and train-state
mappings and the checkpoint layer, against the JAX package and flax.

Tolerance: none. Checkpoints carry float32 bytes across unchanged, so every
leaf that goes from one package to the other must come back bit for bit;
the port's msgpack writer must give flax's bytes for the same tree.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fs

from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import (
    TrainState as JaxTrainState,
)
from meanflow_audio_codec_tpu.training import checkpoints as jckpt
from meanflow_audio_codec_tpu.training.trainer import (
    load_flow_state as jax_load_flow_state,
)
from meanflow_audio_codec_tpu.training.trainer import (
    make_optimizer as jax_make_optimizer,
)
from meanflow_audio_codec_torch import serialization, weights
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.training import checkpoints
from meanflow_audio_codec_torch.training.optim import (
    TrainState,
    make_optimizer,
)
from meanflow_audio_codec_torch.training.trainer import load_flow_state

WINDOW = 64
CONFIG = {
    "config_version": "2.0",
    "base": {"batch_size": 2, "n_steps": 10, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 0, "grad_clip_norm": 1.0},
    "model": {"noise_dimension": 2 * WINDOW, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 2,
              "architecture": "convnet",
              "architecture_options": {"channels": 16, "bottleneck_dim": 32,
                                       "spatial": 4, "lift_channels": 8}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {"frame_size": 1024,
                                        "window_size": WINDOW}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True},
    "training": {"sample_every": 5, "sample_seed": 0, "sample_steps": 1,
                 "workdir": "unused", "ema_decay": 0.9},
    "tpu": {"precision": "float32"},
}


def _config(clip=True, ema=True, schedule=False):
    data = json.loads(json.dumps(CONFIG))
    if schedule:
        data["base"].update(warmup_steps=2, lr_schedule="cosine")
    if not clip:
        del data["base"]["grad_clip_norm"]
    if not ema:
        del data["training"]["ema_decay"]
    return data


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            yield from _leaves(value, name)
        else:
            yield name, value


def _np(value):
    if isinstance(value, torch.Tensor):
        return value.numpy()
    return np.asarray(value)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for name in want:
        if want[name] is None:
            assert got[name] is None, name
            continue
        a, b = _np(got[name]), _np(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {"step": np.asarray(7, np.int32),
            "params": {"Dense_0": {"kernel": rng.standard_normal(
                (3, 4)).astype(np.float32), "bias": np.zeros(4, np.float32)}},
            "half": np.asarray(jnp.asarray(rng.standard_normal((2, 5)),
                                           jnp.bfloat16)),
            "ids": np.arange(300, dtype=np.int32).reshape(3, 100),
            "scalar": np.float32(0.5), "iscalar": np.int32(-3),
            "count": 3, "neg": -70000, "big": 2**40, "rate": 0.125,
            "flag": True, "none": None, "empty": {}, "name": "x" * 40}


def test_port_bytes_are_flax_bytes_and_load_in_flax():
    tree = _mixed_tree()
    ours = dict(tree, half=torch.from_numpy(
        tree["half"].view(np.int16).copy()).view(torch.bfloat16))
    data = serialization.msgpack_serialize(ours)
    assert data == fs.msgpack_serialize(dict(tree), in_place=True)
    _assert_trees_equal(fs.msgpack_restore(data), tree)


def test_flax_bytes_load_in_the_port():
    tree = _mixed_tree()
    back = serialization.msgpack_restore(fs.msgpack_serialize(tree))
    assert back["half"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["half"].view(torch.int16).numpy(),
                                  tree["half"].view(np.int16))
    assert isinstance(back["scalar"], np.float32) and back["scalar"] == 0.5
    assert isinstance(back["iscalar"], np.int32) and back["iscalar"] == -3
    rest = {k: v for k, v in tree.items() if k not in ("half", "scalar",
                                                       "iscalar")}
    _assert_trees_equal({k: back[k] for k in rest}, rest)


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays above the chunk size go as flax's chunked maps (the size is
    lowered on both sides to keep the test small)."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(50, dtype=np.float32).reshape(5, 10),
            "b": np.ones(3, np.float32)}
    ours = serialization.msgpack_serialize(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    assert ours == fs.msgpack_serialize(dict(tree), in_place=True)
    for data in (ours, fs.msgpack_serialize(tree)):
        back = serialization.msgpack_restore(data)
        np.testing.assert_array_equal(back["w"].numpy(), tree["w"])


@pytest.mark.parametrize("data", [b"", b"\xc1", b"\x92\x01", b"\x81\xa1a",
                                  b"\xc7\x03\x09abc", b"\x01\x02"])
def test_reader_rejects_malformed_bytes(data):
    with pytest.raises(ValueError):
        serialization.msgpack_restore(data)


# ---------------------------------------------------------------------------
# parameter and train-state trees
# ---------------------------------------------------------------------------


def _jax_config(**kwargs):
    return TrainFlowConfig.from_dict(_config(**kwargs))


def _jax_params(jcfg, seed=0):
    model = jax_create_flow_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 2 * WINDOW)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes)


@pytest.mark.parametrize("lift", [False, True], ids=["square", "lift"])
def test_torch_to_flax_inverts_flax_to_torch(lift):
    data = _config()
    # a non-square token width gives the encoder its lift Dense
    data["model"]["noise_dimension"] = 2 * WINDOW if lift else 64
    jcfg = TrainFlowConfig.from_dict(data)
    model = jax_create_flow_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, jcfg.noise_dimension)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    assert ("Dense_1" in params["encoder"]) == lift
    back = weights.torch_to_flax(weights.flax_to_torch(params))
    _assert_trees_equal(back, jax.tree_util.tree_map(np.asarray, params))
    with pytest.raises(KeyError):
        weights.torch_to_flax({"stages.0.nope.weight": torch.zeros(1)})


def _port_state(clip=True, ema=True, seed=0, schedule=False):
    cfg = config_from_dict(_config(clip=clip, ema=ema, schedule=schedule))
    model = create_flow_model(cfg, generator=torch.Generator().manual_seed(1))
    state = TrainState(model, make_optimizer(cfg), cfg.ema_decay,
                       device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for tensors in ([state.params, state.mu, state.nu]
                        + ([state.ema] if ema else [])):
            for t in tensors:
                t.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    state.step = 5
    return state


def _jax_template(jcfg, ema=True):
    params = _jax_params(jcfg)
    return JaxTrainState.create(
        apply_fn=None, params=params, tx=jax_make_optimizer(jcfg),
        ema_params=(jax.tree_util.tree_map(jnp.array, params) if ema
                    else None),
        ema_decay=jcfg.training.ema_decay or 0.999)


@pytest.mark.parametrize("clip,ema,schedule", [
    (True, True, False), (False, True, False), (True, False, False),
    (True, True, True)], ids=["clip-ema", "no-clip", "no-ema", "cosine"])
def test_train_state_tree_is_jax_state_dict(clip, ema, schedule):
    """The port's tree has the layout of ``to_state_dict`` of the JAX
    TrainState with the optimiser of the same config."""
    jcfg = _jax_config(clip=clip, ema=ema, schedule=schedule)
    want = fs.to_state_dict(_jax_template(jcfg, ema))
    got = weights.train_state_to_flax(
        _port_state(clip, ema, schedule=schedule))
    shapes = jax.tree_util.tree_map(np.shape, want)
    assert jax.tree_util.tree_map(np.shape, got) == shapes


@pytest.mark.parametrize("clip,ema", [(True, True), (True, False)],
                         ids=["clip-ema", "no-ema"])
def test_port_checkpoint_loads_in_jax(tmp_path, clip, ema):
    state = _port_state(clip, ema)
    path = checkpoints.save_checkpoint_with_metadata(
        state, tmp_path, step=5, config=config_from_dict(_config(clip, ema)))
    jcfg = _jax_config(clip=clip, ema=ema)
    loaded = jckpt.load_checkpoint(path, _jax_template(jcfg, ema))
    want = weights.train_state_to_flax(state)
    _assert_trees_equal(
        jax.tree_util.tree_map(np.asarray, fs.to_state_dict(loaded)), want)
    jstate, _ = jax_load_flow_state(path, jcfg)
    _assert_trees_equal(
        jax.tree_util.tree_map(np.asarray, fs.to_state_dict(jstate)), want)
    meta = json.loads((tmp_path / "step_00005.metadata.json").read_text())
    jmeta = jckpt.checkpoint_metadata(loaded, path)
    assert (set(meta) - {"torch_version", "format"}
            == set(jmeta) - {"jax_version", "flax_version"})
    assert meta["param_shapes"] == jmeta["param_shapes"]
    assert meta["param_count"] == jmeta["param_count"]


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no-ema"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, ema):
    jcfg = _jax_config(ema=ema)
    template = _jax_template(jcfg, ema)
    rng = np.random.default_rng(2)
    jstate = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)).astype(np.float32)
                   if isinstance(a, jax.Array) and a.dtype == jnp.float32
                   else a), template)
    jstate = jstate.replace(step=jnp.asarray(7, jnp.int32))
    path = jckpt.save_checkpoint(jstate, tmp_path / "step_00007.msgpack")
    want = fs.msgpack_restore(path.read_bytes())

    state = _port_state(ema=ema, seed=9)
    checkpoints.load_checkpoint(path, state)
    assert state.step == 7 and int(state.count) == 7
    got = weights.train_state_to_flax(state)
    want["ema_decay"] = np.asarray(want["ema_decay"], np.float32)
    # the optax counts of JAX's fresh template are 0; the port writes its
    # own count there (JAX's trainer keeps them equal to step)
    want["opt_state"]["1"]["0"]["count"] = np.asarray(7, np.int32)
    _assert_trees_equal(got, want)
    loaded, model = load_flow_state(path, config_from_dict(_config(ema=ema)),
                                    device="cpu")
    assert loaded.step == 7 and (loaded.ema is not None) == ema
    _assert_trees_equal(weights.train_state_to_flax(loaded), want)


def test_serving_checkpoints_both_ways(tmp_path):
    state = _port_state()
    path = checkpoints.save_serving_checkpoint(state, tmp_path / "port",
                                               step=12)
    assert path.name == "serving_step_00012.msgpack"
    jcfg = _jax_config()
    step, params = jckpt.load_serving_checkpoint(path, _jax_params(jcfg))
    assert step == 12
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, params),
                        weights.torch_to_flax(state.ema_state_dict()))
    jstate, _ = jax_load_flow_state(path, jcfg)
    assert int(jstate.step) == 12

    jparams = _jax_params(jcfg, seed=4)
    jpath = jckpt.save_serving_checkpoint(
        _jax_template(jcfg).replace(ema_params=jparams), tmp_path / "jax",
        step=30)
    step, loaded = checkpoints.load_serving_checkpoint(jpath)
    assert step == 30
    want = weights.flax_to_torch(jparams)
    assert set(loaded) == set(want)
    for name in want:
        assert torch.equal(loaded[name], want[name]), name
    ours, _ = load_flow_state(jpath, config_from_dict(_config()),
                              device="cpu")
    assert ours.step == 30
    for name, p, e in zip(ours.names, ours.params, ours.ema):
        assert torch.equal(p.detach(), want[name]) and torch.equal(e, p)
    assert checkpoints.find_latest_serving_checkpoint(tmp_path / "jax") == jpath


def test_step_pattern_is_anchored(tmp_path):
    for name in ("step_00010.msgpack", "step_00065.msgpack",
                 "serving_step_00065.msgpack", "step_00070.metadata.json",
                 "xstep_00080.msgpack"):
        (tmp_path / name).write_bytes(b"\x80" * 200)
    assert checkpoints.get_checkpoint_step(
        tmp_path / "serving_step_00065.msgpack") is None
    assert checkpoints.get_checkpoint_step("step_00065.msgpack") == 65
    assert [p.name for p in checkpoints.list_checkpoints(tmp_path)] == [
        "step_00010.msgpack", "step_00065.msgpack"]
    assert checkpoints.is_serving_checkpoint("serving_step_00065.msgpack")
    assert not checkpoints.is_serving_checkpoint("step_00065.msgpack")


def test_retention_keeps_the_final_checkpoint(tmp_path):
    state = _port_state()
    for step in (2, 4, 6, 8):
        checkpoints.save_checkpoint_with_metadata(state, tmp_path, step=step)
    deleted = checkpoints.cleanup_old_checkpoints(tmp_path, 2, final_step=2)
    assert [p.name for p in deleted] == ["step_00004.msgpack",
                                         "step_00006.msgpack"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00002.metadata.json", "step_00002.msgpack",
        "step_00008.metadata.json", "step_00008.msgpack"]
    assert checkpoints.cleanup_old_checkpoints(tmp_path, None) == []


def test_resume_skips_a_corrupted_newest_checkpoint(tmp_path, capsys):
    state = _port_state()
    checkpoints.save_checkpoint_with_metadata(state, tmp_path, step=3)
    good = weights.train_state_to_flax(state)
    newest = checkpoints.save_checkpoint(_port_state(seed=5),
                                         tmp_path / "step_00006.msgpack")
    newest.write_bytes(newest.read_bytes()[:-1000])  # truncated write
    (tmp_path / "step_00009.msgpack").write_bytes(b"\x00")  # too small
    target = _port_state(seed=7)
    restored, step = checkpoints.load_checkpoint_and_resume(tmp_path, target)
    # the start step comes from the file name, as in JAX's resume
    assert step == 3 and restored is target and target.step == state.step
    _assert_trees_equal(weights.train_state_to_flax(target), good)
    out = capsys.readouterr().out
    assert "step_00009.msgpack: file too small" in out
    assert "step_00006.msgpack: structure mismatch" in out
    assert checkpoints.load_checkpoint_and_resume(tmp_path / "none",
                                                  target) is None


def test_structure_mismatch_is_refused(tmp_path):
    path = checkpoints.save_checkpoint(_port_state(clip=False),
                                       tmp_path / "step_00001.msgpack")
    ok, reason = checkpoints.validate_checkpoint_structure(path, _port_state())
    assert not ok and "structure mismatch" in reason
    assert checkpoints.validate_checkpoint_file(path) == (True, "ok")
    with pytest.raises(ValueError):
        checkpoints.load_checkpoint(path, _port_state(ema=False))


@pytest.mark.parametrize("clip,ema,schedule", [
    (True, True, False), (False, True, False), (True, False, False),
    (True, True, True)], ids=["clip-ema", "no-clip", "no-ema", "cosine"])
def test_orbax_checkpoint_saves_and_loads(tmp_path, clip, ema, schedule):
    """An orbax directory of the port's state loads back bit for bit (JAX's
    loaders on it and the port's on JAX's: tests/test_torch_orbax.py)."""
    state = _port_state(clip, ema, schedule=schedule)
    path = checkpoints.save_checkpoint_with_metadata(
        state, tmp_path, step=5, fmt="orbax",
        config=config_from_dict(_config(clip, ema, schedule)))
    assert path == tmp_path / "step_00005.orbax" and path.is_dir()
    meta = json.loads((tmp_path / "step_00005.metadata.json").read_text())
    assert meta["format"] == "orbax" and meta["checkpoint_bytes"] == sum(
        f.stat().st_size for f in path.rglob("*") if f.is_file())
    assert checkpoints.orbax_checkpoint_has_ema(path) == ema
    target = _port_state(clip, ema, seed=3, schedule=schedule)
    target.step = 0
    checkpoints.load_checkpoint_orbax(path, target)
    assert target.step == 5
    _assert_trees_equal(weights.train_state_to_flax(target),
                        weights.train_state_to_flax(state))
    assert checkpoints.validate_checkpoint_structure(path, target) == (
        True, "ok")
    with pytest.raises(ValueError, match="leaves"):
        checkpoints.load_checkpoint_orbax(path, _port_state(clip, not ema))
