"""PyTorch port: the trainer (``train_flow``, ``load_flow_state``) and its
CLI, against the JAX package's ``train_flow`` at a tiny audio config (frame
2048, batch 2, 4 steps in chunks of 2, sampling and checkpoints every 2).

What is compared, and with what tolerance:
  * the workdir's files and each log record's keys: equal sets (the PNG
    plots only where matplotlib imports, on both sides);
  * ``config.json`` written by the port: read by the JAX package's
    ``load_config_from_json``, equal to the JAX run's own but for the
    workdir;
  * checkpoints written by either trainer: loaded by the other, every leaf
    equal bit for bit;
  * the losses of the two runs are not compared: the runs draw their
    initial weights, batches' noise, t and r from different generators
    (tests/test_torch_train.py holds the steps against JAX's with JAX's
    draws).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax import serialization as fs

from meanflow_audio_codec_tpu.configs import (
    TrainFlowConfig,
    load_config_from_json,
)
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import (
    TrainState as JaxTrainState,
)
from meanflow_audio_codec_tpu.ops import sampling as jsampling
from meanflow_audio_codec_tpu.training import checkpoints as jckpt
from meanflow_audio_codec_tpu.training.trainer import (
    load_flow_state as jax_load_flow_state,
)
from meanflow_audio_codec_tpu.training.trainer import (
    make_optimizer as jax_make_optimizer,
)
from meanflow_audio_codec_tpu.training.trainer import (
    train_flow as jax_train_flow,
)
from meanflow_audio_codec_torch import train as cli
from meanflow_audio_codec_torch import weights
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models import conv_flow
from meanflow_audio_codec_torch.ops import sampling
from meanflow_audio_codec_torch.training.logging import read_log
from meanflow_audio_codec_torch.training.trainer import (
    effective_noise_dimension,
    input_example_shape,
    load_flow_state,
    train_flow,
)

TINY = {
    "config_version": "2.0",
    "base": {"batch_size": 2, "n_steps": 4, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3, "grad_clip_norm": 1.0,
             "warmup_steps": 1, "lr_schedule": "cosine",
             "lr_final_fraction": 0.05},
    # noise_dimension is overridden to the tokenized width (64 x 2)
    "model": {"noise_dimension": 100, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 2,
              "architecture": "convnet",
              "architecture_options": {"channels": 16, "bottleneck_dim": 32,
                                       "spatial": 4, "lift_channels": 8}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {
                    "frame_size": 2048, "window_size": 64,
                    "coeff_scale": 4.0, "gain_norm": 0.05,
                    "device_pool_clips": 4, "synthetic_family": "mixed"}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True,
               "time_sampling_full_proportion": 0.25},
    "training": {"sample_every": 2, "sample_seed": 1, "sample_steps": 1,
                 "workdir": "unset", "checkpoint_step": 2,
                 "max_checkpoints_to_keep": 2, "ema_decay": 0.99},
    "tpu": {"precision": "float32", "steps_per_call": 2,
            "skip_nonfinite_updates": True},
}


def _tiny(workdir, **sections):
    data = json.loads(json.dumps(TINY))
    data["training"]["workdir"] = str(workdir)
    for section, values in sections.items():
        data[section].update(values)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer's and the port's workdirs for the tiny config."""
    root = tmp_path_factory.mktemp("trainer")
    jax_train_flow(TrainFlowConfig.from_dict(_tiny(root / "jax")))
    summary = train_flow(config_from_dict(_tiny(root / "port")),
                         device="cpu")
    return root / "jax", root / "port", summary


def _files(workdir):
    return sorted(str(p.relative_to(workdir)) for p in workdir.rglob("*")
                  if p.is_file())


def test_workdir_files_match_jax(runs):
    jax_dir, port_dir, summary = runs
    assert _files(port_dir) == _files(jax_dir)
    assert "checkpoints/step_00004.msgpack" in _files(port_dir)
    assert "checkpoints/serving_step_00004.msgpack" in _files(port_dir)
    assert summary["total_steps"] == 4 and summary["steps_per_sec"] > 0
    assert summary["pool_skipped_refreshes"] >= 0
    assert summary["flops_per_step"] > 0
    assert set(json.loads((jax_dir / "summary.json").read_text())) <= set(
        json.loads((port_dir / "summary.json").read_text()))


def test_log_records_have_jax_keys(runs):
    jax_dir, port_dir, _ = runs
    ours = read_log(port_dir / "logs" / "train_log.jsonl")
    ref = read_log(jax_dir / "logs" / "train_log.jsonl")
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == [
        0, 0, 1, 2, 3]
    for a, b in zip(ours, ref):
        assert set(a) == set(b), a["step"]
    for record in ours[1:]:
        assert np.isfinite(record["loss"]) and record["update_ok"] is True
        assert np.isfinite(record["grad_norm"])
    # the same learning rate at each step (a host formula on both sides)
    np.testing.assert_allclose([r["lr"] for r in ours[1:]],
                               [r["lr"] for r in ref[1:]], rtol=1e-12)


def test_config_json_reads_back_in_jax(runs):
    jax_dir, port_dir, _ = runs
    ours = load_config_from_json(port_dir / "config.json").to_dict()
    ref = load_config_from_json(jax_dir / "config.json").to_dict()
    assert ours["model"]["noise_dimension"] == 128
    for d in (ours, ref):
        d["training"].pop("workdir")
    assert ours == ref


def test_jax_loads_the_port_checkpoints(runs):
    """The port trainer's checkpoint and serving file load in JAX's loaders
    against templates of the JAX TrainState (load_flow_state on port files:
    tests/test_torch_checkpoints.py)."""
    _, port_dir, _ = runs
    jcfg = TrainFlowConfig.from_dict(_tiny(port_dir))
    jcfg.model.noise_dimension = 128
    model = jax_create_flow_model(jcfg)
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 128)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    params = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                    params)
    template = JaxTrainState.create(
        apply_fn=None, params=params, tx=jax_make_optimizer(jcfg),
        ema_params=params, ema_decay=0.99)
    path = port_dir / "checkpoints" / "step_00004.msgpack"
    jstate = jckpt.load_checkpoint(path, template)
    assert int(jstate.step) == 4
    want = fs.msgpack_restore(path.read_bytes())
    got = jax.tree_util.tree_map(np.asarray, fs.to_state_dict(jstate))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    step, serving = jckpt.load_serving_checkpoint(
        port_dir / "checkpoints" / "serving_step_00004.msgpack", params)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(serving),
                    jax.tree_util.tree_leaves(jstate.ema_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_resumes_a_jax_workdir(runs, tmp_path):
    jax_dir, _, _ = runs
    workdir = tmp_path / "resumed"
    shutil.copytree(jax_dir, workdir)
    path = workdir / "checkpoints" / "step_00004.msgpack"
    want = weights.flax_to_torch(
        fs.msgpack_restore(path.read_bytes())["ema_params"])
    config = config_from_dict(_tiny(workdir, base={"n_steps": 6}))

    state, _ = load_flow_state(path, config, device="cpu")
    assert state.step == 4
    for name, e in zip(state.names, state.ema):
        assert torch.equal(e, want[name]), name

    train_flow(config, resume=True, device="cpu")
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    assert len(starts) == 2
    assert [r["step"] for r in records[starts[1] + 1:]] == [4, 5]
    assert (workdir / "config_diff.json").exists()
    diff = json.loads((workdir / "config_diff.json").read_text())
    assert diff["changed"]["base.n_steps"] == {"old": 4, "new": 6}
    names = _files(workdir / "checkpoints")
    assert "step_00006.msgpack" in names and "step_00004.msgpack" in names
    assert "serving_step_00006.msgpack" in names
    assert (workdir / "samples" / "step_00006.wav").exists()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_resume_with_a_truncated_config_trains_on(runs, tmp_path, capsys,
                                                  package):
    """A config.json cut short (e.g. by a crash) is not diffed: both
    trainers say so, write no config_diff.json and train on."""
    jax_dir, _, _ = runs
    workdir = tmp_path / "truncated"
    shutil.copytree(jax_dir, workdir)
    text = (workdir / "config.json").read_text()
    (workdir / "config.json").write_text(text[:len(text) // 2])
    data = _tiny(workdir, base={"n_steps": 6})
    if package == "port":
        train_flow(config_from_dict(data), resume=True, device="cpu")
    else:
        jax_train_flow(TrainFlowConfig.from_dict(data), resume=True)
    assert "Could not diff previous config" in capsys.readouterr().out
    assert not (workdir / "config_diff.json").exists()
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    assert [r["step"] for r in records[starts[-1] + 1:]] == [4, 5]
    assert json.loads((workdir / "config.json").read_text())["base"][
        "n_steps"] == 6


def test_a_qat_run_resumes_from_a_frontier_checkpoint(runs, tmp_path):
    """Chain stage 2c in small: the newest frontier checkpoint and its
    metadata copied into a QAT workdir, then --resume trains on through the
    STE ECSQ grid, and the run serves through the ECSQ 0.5 byte path."""
    _, port_dir, _ = runs
    workdir = tmp_path / "qat"
    (workdir / "checkpoints").mkdir(parents=True)
    for name in ("step_00004.msgpack", "step_00004.metadata.json"):
        shutil.copy(port_dir / "checkpoints" / name, workdir / "checkpoints")
    data = _tiny(workdir, base={"n_steps": 6},
                 method={"qat_mode": "ste", "qat_step_frac": 0.5})
    (tmp_path / "qat.json").write_text(json.dumps(data))
    config = cli.config_from_args(cli.build_parser().parse_args(
        ["--config", str(tmp_path / "qat.json"), "--resume"]))
    assert (config.qat_mode, config.qat_step_frac) == ("ste", 0.5)
    train_flow(config, resume=True, device="cpu")
    records = [r for r in read_log(workdir / "logs" / "train_log.jsonl")
               if "loss" in r]
    assert [r["step"] for r in records] == [4, 5]
    assert all(r["update_ok"] and np.isfinite(r["loss"]) for r in records)
    assert (workdir / "checkpoints" / "step_00006.msgpack").exists()
    codec = AudioCodec.from_workdir(workdir, device="cpu")
    audio = np.random.default_rng(0).standard_normal(
        (1, 4096, 2)).astype(np.float32) * 0.1
    data = codec.encode_bytes(audio, step_frac=0.5)
    out = codec.decode_bytes(data, generator=torch.Generator().manual_seed(0))
    assert out.shape[0] == 1 and out.shape[-1] == 2
    assert out.shape[1] >= 4096 and torch.isfinite(out).all()


def _learned_jax_config(workdir):
    jcfg = TrainFlowConfig.from_dict(_tiny(
        workdir, method={"loss_weighting": "learned"}))
    jcfg.model.noise_dimension = 128
    return jcfg


def test_learned_weighting_checkpoints_cross_both_ways(tmp_path):
    """The polynomial sits at params["loss_weighting"]["poly"] (and in the
    moments and the EMA): the port's trained checkpoint loads in JAX's
    load_flow_state, and a JAX checkpoint in the port's."""
    workdir = tmp_path / "port"
    config = config_from_dict(_tiny(workdir, base={"n_steps": 2},
                                    method={"loss_weighting": "learned"}))
    train_flow(config, device="cpu")
    path = workdir / "checkpoints" / "step_00002.msgpack"
    state, _ = load_flow_state(path, config, device="cpu")
    poly = dict(zip(state.names, state.params))["loss_weighting.poly"]
    poly = poly.detach()
    assert poly.abs().max() > 0  # trained jointly with the model
    jstate, _ = jax_load_flow_state(path, _learned_jax_config(workdir))
    np.testing.assert_array_equal(
        np.asarray(jstate.params["loss_weighting"]["poly"]), poly.numpy())
    ema = dict(zip(state.names, state.ema))["loss_weighting.poly"]
    np.testing.assert_array_equal(
        np.asarray(jstate.ema_params["loss_weighting"]["poly"]), ema.numpy())

    # the reverse: a JAX state with a learned slot, saved by JAX
    jpath = tmp_path / "jax" / "step_00003.msgpack"
    poly_j = np.asarray([0.25, -0.5, 0.125], np.float32)
    params = dict(jstate.params)
    params["loss_weighting"] = {"poly": jnp.asarray(poly_j)}
    jckpt.save_checkpoint(jstate.replace(params=params, step=3), jpath)
    state, model = load_flow_state(jpath, config, device="cpu")
    assert state.step == 3
    np.testing.assert_array_equal(model.loss_weighting.poly.detach().numpy(),
                                  poly_j)


SAMPLE_FLOW = dict(noise_dimension=64, condition_dimension=16, num_blocks=2,
                   latent_dimension=8, channels=16, bottleneck_dim=32,
                   spatial=4, lift_channels=8)


def _sampling_models():
    """A small JAX convnet flow with seeded parameters, the port's twin and
    three latents."""
    flow = SAMPLE_FLOW
    jmodel = jax_create_flow_model(TrainFlowConfig.from_dict({
        **_tiny("unused"), "model": {
            "noise_dimension": 64, "condition_dimension": 16,
            "latent_dimension": 8, "num_blocks": 2,
            "architecture": "convnet", "architecture_options": {
                k: flow[k] for k in ("channels", "bottleneck_dim",
                                     "spatial", "lift_channels")}}}))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((2, 64)), jnp.zeros((2, 2)),
            method="init_all"))["params"])
    latents = rng.standard_normal((3, 8)).astype(np.float32)
    model = weights.load_flax_params(conv_flow.ConditionalConvFlow(**flow),
                                     params)
    return jmodel, params, model, latents


@pytest.mark.parametrize("n_steps,guidance", [(1, 1.0), (3, 1.0), (2, 2.0)])
def test_flow_matching_sampling_matches_jax_heun(n_steps, guidance):
    """The trainer's flow-matching sampler against JAX's ``sample``: the
    same grid (linspace(1, 0, n), dt = 1/n), the initial noise JAX draws
    from its key passed in."""
    jmodel, params, model, latents = _sampling_models()
    key = jax.random.PRNGKey(7)
    want = jsampling.sample(jmodel.apply, 64, params, key,
                            jnp.asarray(latents), n_steps=n_steps,
                            guidance_scale=guidance)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (3, 64))))
    got = sampling.sample(model, 64, torch.from_numpy(latents),
                          n_steps=n_steps, guidance_scale=guidance,
                          noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n_steps,guidance", [(1, 1.0), (2, 2.0)])
def test_improved_mean_flow_sampling_matches_jax(n_steps, guidance):
    """``sample(use_improved_mean_flow=True)`` takes the dual-time sampler,
    as JAX's does; the initial noise JAX draws from its key passed in
    (rtol 1e-5 / atol 1e-5 on samples of magnitude up to about 3: the same
    float32 forwards summed in another order, through the guidance blend)."""
    jmodel, params, model, latents = _sampling_models()
    key = jax.random.PRNGKey(7)
    want = jsampling.sample(jmodel.apply, 64, params, key,
                            jnp.asarray(latents), n_steps=n_steps,
                            use_improved_mean_flow=True,
                            guidance_scale=guidance)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (3, 64))))
    got = sampling.sample(model, 64, torch.from_numpy(latents), n_steps,
                          guidance, noise, use_improved_mean_flow=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got, sampling.sample_dual_time(
        model, 64, torch.from_numpy(latents), n_steps=n_steps,
        guidance_scale=guidance, noise=noise), rtol=0, atol=0)


@pytest.mark.parametrize("method", ["autoencoder", "flow_matching",
                                    "mean_flow"])
def test_every_method_trains_and_samples_as_jax_does(tmp_path, method):
    """Two steps of each method through the trainer; autoencoder runs write
    no samples (JAX's run_sampling returns first), the flow methods write a
    WAV per sampling point."""
    workdir = tmp_path / method
    config = config_from_dict(_tiny(
        workdir, base={"n_steps": 2},
        method={"method": method, "use_improved_mean_flow": False}))
    train_flow(config, device="cpu")
    records = [r for r in read_log(workdir / "logs" / "train_log.jsonl")
               if "loss" in r]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)
    wavs = sorted(p.name for p in (workdir / "samples").glob("*.wav"))
    assert wavs == ([] if method == "autoencoder" else ["step_00002.wav"])


def test_geometry_helpers():
    config = config_from_dict(_tiny("unused"))
    assert input_example_shape(config) == (2048, 2)
    assert effective_noise_dimension(config) == 128


@pytest.mark.parametrize("section,values,error", [
    # mnist trains; an unknown tokenization on it is refused before any
    # file is written
    ("dataset", {"dataset": "mnist", "tokenization_strategy": "wavelet"},
     ValueError),
    ("method", {"loss_strategy": "diffusion"}, ValueError),
    # a mesh the process group cannot hold (4 data ranks in a group of 1)
    ("tpu", {"mesh_data": 4}, ValueError),
    ("model", {"architecture_options": {"channels": 16, "spatial": 4,
                                        "quantized": True}}, ValueError),
], ids=["mnist", "objective", "devices", "quantized"])
def test_train_flow_refuses_what_is_not_ported(tmp_path, section, values,
                                               error):
    # an unknown tokenization or objective is refused when the config is
    # read, as the JAX package's validation does; the rest by train_flow.
    # The mesh is built in a process group only (here one of 1 rank);
    # without one a run trains unsharded, as JAX's does on one device.
    grouped = section == "tpu"
    if grouped:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        with pytest.raises(error):
            train_flow(config_from_dict(_tiny(tmp_path / "run",
                                              **{section: values})),
                       device="cpu")
    finally:
        if grouped:
            dist.destroy_process_group()
    assert not (tmp_path / "run").exists()


def test_train_flow_writes_orbax_checkpoints(tmp_path):
    """checkpoint_format orbax: the run writes step_N.orbax directories
    with sidecars, keeps two of them, and resumes from the newest (the
    cross-package checks: tests/test_torch_orbax.py)."""
    workdir = tmp_path / "run"
    data = _tiny(workdir, training={"checkpoint_format": "orbax"})
    train_flow(config_from_dict(data), device="cpu")
    names = _files(workdir / "checkpoints")
    assert {n.split("/")[0] for n in names} == {
        "step_00002.orbax", "step_00004.orbax", "step_00002.metadata.json",
        "step_00004.metadata.json", "serving_step_00004.msgpack"}
    sidecar = json.loads(
        (workdir / "checkpoints" / "step_00004.metadata.json").read_text())
    assert sidecar["format"] == "orbax" and sidecar["step"] == 4
    state, _ = load_flow_state(workdir / "checkpoints" / "step_00004.orbax",
                               config_from_dict(data), device="cpu")
    assert state.step == 4 and state.ema is not None

    data["base"]["n_steps"] = 6
    train_flow(config_from_dict(data), resume=True, device="cpu")
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    assert [r["step"] for r in records[starts[-1] + 1:]] == [4, 5]
    assert sorted(p.name for p in (workdir / "checkpoints").glob(
        "step_*.orbax")) == ["step_00004.orbax", "step_00006.orbax"]


def test_train_flow_asks_for_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_flow(config_from_dict(_tiny(tmp_path)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

HONOURED = {
    "--batch-size": ("4", "batch_size", 4),
    "--n-steps": ("48", "n_steps", 48),
    "--seed": ("9", "seed", 9),
    "--sample-every": ("32", "sample_every", 32),
    "--sample-steps": ("2", "sample_steps", 2),
    "--sample-seed": ("5", "sample_seed", 5),
    "--checkpoint-step": ("16", "checkpoint_step", 16),
    "--max-checkpoints-to-keep": ("2", "max_checkpoints_to_keep", 2),
    "--ema-decay": ("0.5", "ema_decay", 0.5),
    "--precision": ("bfloat16", "precision", "bfloat16"),
    "--steps-per-call": ("16", "steps_per_call", 16),
}


@pytest.fixture
def config_file(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_tiny(tmp_path / "from_config")))
    return path


@pytest.fixture
def calls(monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "train_flow",
                        lambda config, resume: seen.append((config, resume)))
    return seen


def test_cli_honours_its_flags(config_file, calls, tmp_path):
    argv = ["--config", str(config_file), "--workdir", str(tmp_path / "w"),
            "--resume", "--frame-size", "4096", "--device-pool-clips", "64",
            "--pool-batches", "3", "--skip-nonfinite"]
    for flag, (value, _, _) in HONOURED.items():
        argv += [flag, value]
    assert cli.main(argv) == 0
    (config, resume), = calls
    assert resume is True
    for _, name, want in HONOURED.values():
        assert getattr(config, name) == want, name
    assert config.workdir == str(tmp_path / "w")
    assert config.skip_nonfinite_updates is True
    tok = config.tokenization_config
    assert (tok["frame_size"], tok["device_pool_clips"],
            tok["pool_batches"], tok["window_size"]) == (4096, 64, 3, 64)


def test_cli_keeps_the_config_without_flags(config_file, calls):
    assert cli.main(["--config", str(config_file)]) == 0
    (config, resume), = calls
    assert resume is False
    assert config == config_from_dict(json.loads(config_file.read_text()))


#: the root CLI's flags that the port's CLI refused before it took the
#: flag-driven config: flag -> (value, the config's value it sets)
ROOT_FLAGS = {
    "--dataset": ("mnist", lambda c: c.dataset, "mnist"),
    "--method": ("mean_flow", lambda c: c.method, "mean_flow"),
    "--architecture": ("mlp", lambda c: c.architecture, "mlp"),
    "--tokenization": ("reshape", lambda c: c.tokenization_strategy,
                       "reshape"),
    "--base-lr": ("0.002", lambda c: c.base_lr, 0.002),
    "--weight-decay": ("0.5", lambda c: c.weight_decay, 0.5),
    "--noise-dimension": ("96", lambda c: c.noise_dimension, 96),
    "--condition-dimension": ("32", lambda c: c.condition_dimension, 32),
    "--latent-dimension": ("12", lambda c: c.latent_dimension, 12),
    "--num-blocks": ("3", lambda c: c.num_blocks, 3),
    "--gamma": ("0.25", lambda c: c.gamma, 0.25),
    "--full-interval-proportion": (
        "0.25", lambda c: c.time_sampling_full_proportion, 0.25),
    "--window-size": ("128", lambda c: c.tokenization_config["window_size"],
                      128),
    "--coeff-scale": ("2.0", lambda c: c.tokenization_config["coeff_scale"],
                      2.0),
    "--architecture-options": (
        '{"channels": 8}', lambda c: c.architecture_options["channels"], 8),
    "--grad-clip-norm": ("0.5", lambda c: c.grad_clip_norm, 0.5),
    "--warmup-steps": ("7", lambda c: c.warmup_steps, 7),
    "--lr-schedule": ("constant", lambda c: c.lr_schedule, "constant"),
    "--lr-final-fraction": ("0.1", lambda c: c.lr_final_fraction, 0.1),
}


@pytest.mark.parametrize("flag", ROOT_FLAGS)
def test_cli_refuses_the_root_cli_flags_it_does_not_port(config_file, calls,
                                                         tmp_path, flag):
    """Every root flag the port's CLI once refused now sets its field: in a
    flag-driven run (the default config of --dataset) and, but for
    --dataset, which only picks that default, over a --config file."""
    value, read, want = ROOT_FLAGS[flag]
    workdir = str(tmp_path / "w")
    assert cli.main(["--workdir", workdir, flag, value]) == 0
    runs = [["--config", str(config_file), flag, value]]
    if flag != "--dataset":
        assert cli.main(*runs) == 0
    for config, resume in calls:
        assert read(config) == want and resume is False
    assert len(calls) == (1 if flag == "--dataset" else 2)
    assert calls[0][0].workdir == workdir


def test_cli_needs_a_config(calls, capsys, tmp_path):
    """Without --config and --workdir the CLI stops (exit 2), as the root
    CLI does; with --workdir alone it trains the default MNIST config."""
    assert cli.main(["--n-steps", "3"]) == 2
    assert "--config and/or --workdir" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--config", "x.json", "--bogus"])
    assert calls == []
    assert cli.main(["--workdir", str(tmp_path), "--n-steps", "3"]) == 0
    (config, _), = calls
    assert (config.dataset, config.n_steps, config.noise_dimension) == (
        "mnist", 3, 784)
