"""PyTorch port: training on a disk corpus and serving the run, against the
JAX package.

A tiny audio config (frame 2048, W 64, batch 2, chunks of 2 steps) over a
directory of 3 WAV clips and 1 FLAC clip runs through the port's CLI with
``--data-dir``: 2 steps, then ``--resume`` to 4, with the JAX package's
device-pool default (0 for a corpus: the exact stream). Checked: the log,
the checkpoints, JAX's ``load_flow_state`` on the port's checkpoint (every
leaf bit for bit), the data flags against the root CLI's, the parameter
count of ``configs/corpus_rehearsal.json``'s width in both packages, and the
codec CLI on FLAC and AIFF input (the same samples in WAV, FLAC and AIFF
encode to the same bytes).
"""

import contextlib
import importlib.util
import io
import json
import struct
import wave
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization as fs

from meanflow_audio_codec_tpu.configs import (
    TrainFlowConfig,
    load_config_from_json,
)
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.training.trainer import (
    effective_noise_dimension as jax_noise_dimension,
)
from meanflow_audio_codec_tpu.training.trainer import (
    load_flow_state as jax_load_flow_state,
)
from meanflow_audio_codec_torch import train as cli
from meanflow_audio_codec_torch.configs import config_from_dict, load_config
from meanflow_audio_codec_torch.data.audio import load_audio_file, write_wav
from meanflow_audio_codec_torch.data.flac_write import (
    write_flac,
    write_flac_pcm16,
)
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops.mdct import num_frames_for_length
from meanflow_audio_codec_torch.tools import codec_cli
from meanflow_audio_codec_torch.training.logging import read_log
from meanflow_audio_codec_torch.training.trainer import (
    device_pool_clips,
    effective_noise_dimension,
    train_flow,
)

REPO = Path(__file__).resolve().parents[1]
REHEARSAL = REPO / "configs" / "corpus_rehearsal.json"

TINY = {
    "config_version": "2.0",
    "base": {"batch_size": 2, "n_steps": 4, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3, "grad_clip_norm": 1.0,
             "warmup_steps": 1, "lr_schedule": "cosine",
             "lr_final_fraction": 0.05},
    "model": {"noise_dimension": 128, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 2,
              "architecture": "convnet",
              "architecture_options": {"channels": 16, "bottleneck_dim": 32,
                                       "spatial": 4, "lift_channels": 8}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {"frame_size": 2048,
                                        "window_size": 64,
                                        "coeff_scale": 4.0,
                                        "gain_norm": 0.05}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True,
               "time_sampling_full_proportion": 0.25},
    "training": {"sample_every": 4, "sample_seed": 1, "sample_steps": 1,
                 "workdir": "unset", "checkpoint_step": 2,
                 "max_checkpoints_to_keep": 2, "ema_decay": 0.99},
    "tpu": {"precision": "float32", "steps_per_call": 2,
            "skip_nonfinite_updates": True},
}


def _tiny(workdir, data_dir=None, **tok):
    data = json.loads(json.dumps(TINY))
    data["training"]["workdir"] = str(workdir)
    if data_dir is not None:
        data["dataset"]["data_dir"] = str(data_dir)
    data["dataset"]["tokenization_config"].update(tok)
    return data


def _make_corpus(root: Path) -> Path:
    rng = np.random.default_rng(0)
    root.mkdir(parents=True)
    for i in range(3):
        write_wav(root / f"clip{i}.wav",
                  rng.uniform(-0.5, 0.5, (3000 + 1000 * i, 2)))
    write_flac_pcm16(root / "clip3.flac", rng.uniform(-0.5, 0.5, (5000, 2)))
    return root


@pytest.fixture(scope="module")
def disk_run(tmp_path_factory):
    """The port's CLI over the corpus: 2 steps, then --resume to 4, on the
    CPU; returns the workdir, the config file and the printed output."""
    root = tmp_path_factory.mktemp("disk")
    corpus = _make_corpus(root / "corpus")
    config_file = root / "tiny.json"
    config_file.write_text(json.dumps(_tiny(root / "unused")))
    workdir = root / "run"
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(cli, "train_flow", partial(train_flow, device="cpu"))
        for extra in (["--n-steps", "2"], ["--resume", "--n-steps", "4"]):
            assert cli.main(["--config", str(config_file), "--data-dir",
                             str(corpus), "--workdir", str(workdir)]
                            + extra) == 0
    return workdir, corpus, out.getvalue()


@pytest.mark.parametrize("on_disk,pool,want", [
    (True, None, 0), (False, None, 1024), (True, 64, 64), (False, 0, 0),
    ("missing", None, 1024)],
    ids=["corpus", "synthetic", "corpus_set", "synthetic_set", "missing_dir"])
def test_device_pool_default_is_jax(tmp_path, on_disk, pool, want):
    """JAX's rule (training/trainer.py's ``device_pool_clips``): the
    config's value, else 0 for an existing ``data_dir`` and 1024 otherwise
    (a ``data_dir`` that does not exist means synthetic audio)."""
    data_dir = {True: tmp_path, False: None,
                "missing": tmp_path / "absent"}[on_disk]
    tok = {} if pool is None else {"device_pool_clips": pool}
    config = config_from_dict(_tiny(tmp_path / "w", data_dir, **tok))
    assert device_pool_clips(config) == want


def test_disk_run_trains_and_resumes(disk_run):
    workdir, _, out = disk_run
    records = read_log(workdir / "logs" / "train_log.jsonl")
    starts = [i for i, r in enumerate(records) if r.get("event") == "start"]
    steps = [r for r in records if "event" not in r]
    assert len(starts) == 2 and [r["step"] for r in steps] == [0, 1, 2, 3]
    assert records[starts[1] + 1]["step"] == 2
    assert all(np.isfinite(r["loss"]) and r["update_ok"] for r in steps)
    assert "Resumed from step 2" in out
    assert "synthetic" not in out and "Device replay pool" not in out
    names = sorted(p.name for p in (workdir / "checkpoints").iterdir())
    assert names == ["serving_step_00002.msgpack",
                     "serving_step_00004.msgpack",
                     "step_00002.metadata.json", "step_00002.msgpack",
                     "step_00004.metadata.json", "step_00004.msgpack"]
    summary = json.loads((workdir / "summary.json").read_text())
    assert summary["total_steps"] == 2 and "pool_skipped_refreshes" not in (
        summary)
    assert (workdir / "samples" / "step_00004.wav").exists()
    saved = json.loads((workdir / "config.json").read_text())
    assert Path(saved["dataset"]["data_dir"]) == disk_run[1]


def test_jax_loads_the_disk_runs_checkpoint(disk_run):
    workdir, corpus, _ = disk_run
    path = workdir / "checkpoints" / "step_00004.msgpack"
    jcfg = TrainFlowConfig.from_dict(_tiny(workdir, corpus))
    state, _ = jax_load_flow_state(path, jcfg)
    assert int(state.step) == 4
    want = fs.msgpack_restore(path.read_bytes())
    got = jax.tree_util.tree_map(np.asarray, fs.to_state_dict(state))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def _root_cli():
    spec = importlib.util.spec_from_file_location("root_train",
                                                  REPO / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags", [
    [], ["--data-dir", "corpus/flac"], ["--resample-audio"],
    ["--data-dir", "c", "--resample-audio", "--device-pool-clips", "64"]],
    ids=["none", "data_dir", "resample", "both_and_pool"])
def test_data_flags_reach_the_config_as_in_the_root_cli(tmp_path, flags):
    config_file = tmp_path / "tiny.json"
    config_file.write_text(json.dumps(_tiny(tmp_path / "w", "preset")))
    argv = ["--config", str(config_file)] + flags
    root = _root_cli()
    ref = root.config_from_args(root.build_parser().parse_args(argv))
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert ours.data_dir == ref.data_dir
    assert ours.resample_audio == ref.resample_audio
    assert (ours.tokenization_config.get("device_pool_clips")
            == ref.tokenization_config.get("device_pool_clips"))
    assert ours.data_dir == ("preset" if "--data-dir" not in flags
                             else flags[flags.index("--data-dir") + 1])


def test_corpus_rehearsal_width_has_jax_parameter_count():
    """configs/corpus_rehearsal.json: channels 512, bottleneck 1024, lift
    64, spatial 8, 8 blocks, latent 256."""
    config = load_config(REHEARSAL)
    assert effective_noise_dimension(config) == config.noise_dimension
    model = create_flow_model(config)
    ours = sum(p.numel() for p in model.parameters())
    jcfg = load_config_from_json(str(REHEARSAL))
    noise_dim = jax_noise_dimension(jcfg)
    shapes = jax.eval_shape(lambda: jax_create_flow_model(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, noise_dim)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    theirs = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(shapes))
    assert ours == theirs == 114_472_384


def _aiff(path: Path, pcm: np.ndarray) -> None:
    """(T, 2) int16 samples as a 16-bit 44.1 kHz AIFF."""
    data = pcm.astype(">i2").tobytes()
    comm = (struct.pack(">hIh", 2, pcm.shape[0], 16)
            + b"\x40\x0e\xac\x44" + bytes(6))  # 44100 as 80-bit extended
    ssnd = struct.pack(">II", 0, 0) + data
    body = (b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    path.write_bytes(b"FORM" + struct.pack(">I", 4 + len(body)) + b"AIFF"
                     + body)


def test_codec_cli_encodes_flac_and_aiff_input(disk_run, tmp_path, capsys):
    """The same 16-bit samples as WAV, FLAC and AIFF encode to the same
    bytes; the FLAC's stream decodes to audio of the frame-implied
    length."""
    workdir, _, _ = disk_run
    pcm = np.random.default_rng(8).integers(-20000, 20000, size=(6000, 2))
    with wave.open(str(tmp_path / "in.wav"), "wb") as wav:
        wav.setnchannels(2)
        wav.setsampwidth(2)
        wav.setframerate(44100)
        wav.writeframes(pcm.astype(np.int16).tobytes())
    write_flac(tmp_path / "in.flac", pcm.T, mode="fixed2", stereo="mid_side",
               blocksize=4096)
    _aiff(tmp_path / "in.aiff", pcm)
    device = ["--device", "cpu"]
    encoded = {}
    for suffix in ("wav", "flac", "aiff"):
        out = tmp_path / f"{suffix}.macb"
        assert codec_cli.main(["encode", str(tmp_path / f"in.{suffix}"),
                               "--workdir", str(workdir), "-o", str(out)]
                              + device) == 0
        encoded[suffix] = out.read_bytes()
    assert encoded["flac"] == encoded["wav"] == encoded["aiff"]
    assert codec_cli.main(["info", str(tmp_path / "flac.macb")]) == 0
    assert codec_cli.main(["decode", str(tmp_path / "flac.macb"),
                           "--workdir", str(workdir), "-o",
                           str(tmp_path / "out.wav")] + device) == 0
    assert "MACB v1" in capsys.readouterr().out
    decoded = load_audio_file(tmp_path / "out.wav")
    nf = num_frames_for_length(6000, 64, 32)
    assert decoded.shape == (2, (nf - 1) * 32 + 128)
    assert np.abs(decoded).max() > 0
