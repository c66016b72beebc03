"""PyTorch port: the evaluation and results tools against the JAX package's.

Two tiny runs written by the port's trainer (``device="cpu"``): an audio
MDCT ConvNeXt codec (W=64 stereo, frame 2048, gain-normalised, EMA) and a
synthetic-MNIST MLP flow. Compared:

  * ``evaluate_all`` over a config with a checkpoint and one without: the
    CSV's columns and each row's identity columns (config, method,
    architecture, dataset, tokenization, nfe, param_count) equal JAX's, the
    metrics finite (the start noise is each framework's own draw), both
    print the "skip"; ``--quantized`` evaluates the convnet run through
    the int8 decoder and fails the MLP run in both packages;
  * ``eval_suite``: the same passes with the same file names and arguments;
  * ``export_serving``: the port's file read by JAX's
    ``load_serving_checkpoint`` and JAX's by the port's give the same
    arrays, bit for bit;
  * ``export_samples``: the same WAV names (the kbps in them from the same
    bytes) and sidecar keys;
  * ``aggregate_results``, ``generate_tables`` (also ``--curated`` over the
    committed run CSVs), ``ablation_tables``, ``generate_configs`` and
    ``migrate_configs``: the same bytes from the same inputs.
"""

import csv
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.tools import ablation_tables as j_ablation
from meanflow_audio_codec_tpu.tools import aggregate_results as j_aggregate
from meanflow_audio_codec_tpu.tools import eval_suite as j_suite
from meanflow_audio_codec_tpu.tools import evaluate_all as j_evaluate_all
from meanflow_audio_codec_tpu.tools import export_samples as j_export
from meanflow_audio_codec_tpu.tools import export_serving as j_serving
from meanflow_audio_codec_tpu.tools import generate_configs as j_generate
from meanflow_audio_codec_tpu.tools import generate_tables as j_tables
from meanflow_audio_codec_tpu.tools import migrate_configs as j_migrate
from meanflow_audio_codec_tpu.training import checkpoints as jckpt
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.tools import (
    ablation_tables,
    aggregate_results,
    eval_suite,
    evaluate_all,
    export_samples,
    export_serving,
    generate_configs,
    generate_tables,
    migrate_configs,
)
from meanflow_audio_codec_torch.training import checkpoints
from meanflow_audio_codec_torch.training.trainer import train_flow

REPO = Path(__file__).resolve().parents[1]
ID_COLUMNS = ("config", "method", "architecture", "dataset", "tokenization",
              "nfe", "param_count")

AUDIO = {
    "base": {"batch_size": 2, "n_steps": 2, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3},
    "model": {"noise_dimension": 128, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 1,
              "architecture": "convnet",
              "architecture_options": {"channels": 16, "bottleneck_dim": 32,
                                       "spatial": 4, "lift_channels": 8}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {
                    "frame_size": 2048, "window_size": 64,
                    "coeff_scale": 4.0, "gain_norm": 0.05,
                    "device_pool_clips": 4, "synthetic_family": "mixed"}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True},
    "training": {"sample_every": 1000, "sample_seed": 1, "sample_steps": 1,
                 "checkpoint_step": 2, "ema_decay": 0.99},
    "tpu": {"precision": "float32", "steps_per_call": 2},
}
MNIST = {
    "base": {"batch_size": 4, "n_steps": 2, "base_lr": 1e-3,
             "weight_decay": 0.0, "seed": 0},
    "model": {"noise_dimension": 784, "condition_dimension": 8,
              "latent_dimension": 4, "num_blocks": 1},
    "dataset": {"dataset": "mnist", "tokenization_strategy": "reshape"},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True},
    "training": {"sample_every": 1000, "sample_seed": 0, "sample_steps": 1,
                 "checkpoint_step": 2, "ema_decay": 0.9},
    "tpu": {"precision": "float32"},
}


def _config(data: dict, workdir: Path) -> dict:
    data = json.loads(json.dumps(data))
    data["training"]["workdir"] = str(workdir)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for name, data in (("audio", AUDIO), ("mnist", MNIST)):
        train_flow(config_from_dict(_config(data, root / name)),
                   device="cpu")
        out[name] = root / name
    return out


def _rows(path: Path) -> list[dict]:
    with path.open() as fh:
        return list(csv.DictReader(fh))


# ---------------------------------------------------------------------------
# evaluate_all and eval_suite
# ---------------------------------------------------------------------------


def test_evaluate_all_writes_jax_csv_rows_and_skips(runs, tmp_path, capsys):
    configs_dir = tmp_path / "configs"
    configs_dir.mkdir()
    (configs_dir / "a_mnist.json").write_text(json.dumps(
        json.loads((runs["mnist"] / "config.json").read_text())))
    (configs_dir / "b_untrained.json").write_text(json.dumps(
        _config(MNIST, tmp_path / "never_trained")))
    argv = ["--configs", str(configs_dir), "--nfe", "1", "2",
            "--num-samples", "8", "--timing-runs", "1"]
    assert j_evaluate_all.main(argv + ["--csv", str(tmp_path / "jax.csv"),
                                       "--results-name", "jax.json"]) == 0
    jax_out = capsys.readouterr().out
    assert evaluate_all.main(argv + ["--csv", str(tmp_path / "port.csv"),
                                     "--results-name", "port.json",
                                     "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    for out in (jax_out, port_out):
        assert "skip b_untrained.json: no checkpoint" in out
        assert "Evaluated 1/2 configs" in out
    ref, got = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
    assert list(got[0]) == list(ref[0])
    assert "psnr_db" in got[0] and "fid_pixel" in got[0]
    assert [[r[k] for k in ID_COLUMNS] for r in got] == [
        [r[k] for k in ID_COLUMNS] for r in ref]
    assert [r["nfe"] for r in got] == ["1", "2"]
    for row in got:
        assert all(np.isfinite(float(row[k])) for k in row
                   if k not in ID_COLUMNS[:5])
    results = json.loads((runs["mnist"] / "port.json").read_text())
    assert list(results) == list(json.loads(
        (runs["mnist"] / "jax.json").read_text()))


def test_evaluate_all_refuses_quantized_naming_the_roadmap(runs, tmp_path,
                                                          capsys):
    """``--quantized`` (refused, naming its ROADMAP item, until W8A8 was
    ported): the convnet run is evaluated through the int8 decoder; the MLP
    run fails in both packages, whose MLP factory takes no ``quantized``."""
    configs_dir = tmp_path / "configs"
    configs_dir.mkdir()
    for name in ("audio", "mnist"):
        shutil.copy(runs[name] / "config.json", configs_dir / f"{name}.json")
    argv = ["--configs", str(configs_dir), "--quantized", "--nfe", "1",
            "--num-samples", "2", "--timing-runs", "0"]
    assert evaluate_all.main(argv + ["--csv", str(tmp_path / "port.csv"),
                                     "--results-name", "q.json",
                                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAILED mnist.json" in out and "Evaluated 1/2 configs" in out
    (row,) = _rows(tmp_path / "port.csv")
    assert row["config"] == "audio" and np.isfinite(float(row["si_snr_db"]))
    # JAX's MLP factory refuses it the same way
    (configs_dir / "audio.json").unlink()
    assert j_evaluate_all.main(argv + ["--csv", str(tmp_path / "jax.csv")]) \
        == 0
    assert "FAILED mnist.json" in capsys.readouterr().out
    quantized = evaluate_all.evaluate_config(
        runs["audio"] / "config.json", [1], 2, None, results_name="q.json",
        quantized=True, timing_runs=0, device="cpu")
    plain = evaluate_all.evaluate_config(
        runs["audio"] / "config.json", [1], 2, None, results_name="p.json",
        timing_runs=0, device="cpu")
    assert quantized["nfe_sweep"]["1"] != plain["nfe_sweep"]["1"]


def test_load_real_data_draws_as_jax(runs):
    """The held-out clips: the synthetic family at seed+1, and MNIST's test
    split, equal to the JAX package's arrays."""
    from meanflow_audio_codec_tpu.configs import load_config_from_json
    from meanflow_audio_codec_torch.configs import load_config

    for name, family in (("audio", "rich"), ("audio", None), ("mnist", None)):
        path = runs[name] / "config.json"
        got = evaluate_all.load_real_data(load_config(path), 3, family)
        want = j_evaluate_all.load_real_data(load_config_from_json(path), 3,
                                             family)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _recorded_passes(module, monkeypatch, argv):
    seen = []
    monkeypatch.setattr(module, "evaluate_config",
                        lambda path, **kw: seen.append(
                            (Path(path).name, {k: v for k, v in kw.items()
                                               if k != "device"})))
    assert module.main(argv) == 0
    return seen


@pytest.mark.parametrize("extra", [
    [], ["--label", "_step65k", "--cross-family", "rich", "speech",
         "--latent-steps", "0.25", "0.5"],
    ["--cross-family", "--latent-steps", "--latent-bits", "0"]],
    ids=["defaults", "label+families", "float-only"])
def test_eval_suite_runs_jax_passes(runs, monkeypatch, extra):
    argv = ["--workdir", str(runs["audio"]), "--num-samples", "4"] + extra
    ref = _recorded_passes(j_suite, monkeypatch, argv)
    got = _recorded_passes(eval_suite, monkeypatch, argv + ["--device",
                                                            "cpu"])
    assert got == ref


def test_eval_suite_writes_every_pass(runs):
    workdir = runs["audio"]
    assert eval_suite.main(["--workdir", str(workdir), "--num-samples", "2",
                            "--nfe", "1", "2", "--timing-runs", "1",
                            "--label", "_t", "--device", "cpu"]) == 0
    names = sorted(p.name for p in workdir.glob("evaluation_results_t*"))
    assert names == ["evaluation_results_t.json",
                     "evaluation_results_t_bits8.json",
                     "evaluation_results_t_ecsq0.5.json",
                     "evaluation_results_t_rich.json"]
    main = json.loads((workdir / names[0]).read_text())
    assert list(main["nfe_sweep"]) == ["1", "2"]
    for name in names[1:3]:
        stored = json.loads((workdir / name).read_text())
        assert stored["bitstream_kbps_measured"] > 0


# ---------------------------------------------------------------------------
# export_serving and export_samples
# ---------------------------------------------------------------------------


def _copy_run(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    for path in dst.glob("checkpoints/serving_step_*.msgpack"):
        path.unlink()
    return dst


def test_export_serving_files_read_both_ways(runs, tmp_path):
    ours = _copy_run(runs["audio"], tmp_path / "ours")
    theirs = _copy_run(runs["audio"], tmp_path / "theirs")
    assert export_serving.main(["--workdir", str(ours)]) == 0
    assert j_serving.main(["--workdir", str(theirs)]) == 0
    name = "checkpoints/serving_step_00002.msgpack"
    template = checkpoints.read_checkpoint(
        ours / "checkpoints" / "step_00002.msgpack")["params"]
    jstep, jparams = jckpt.load_serving_checkpoint(ours / name, template)
    step, params = checkpoints.load_serving_checkpoint(theirs / name)
    assert jstep == step == 2
    from meanflow_audio_codec_torch import weights
    ours_tree = weights.torch_to_flax(
        checkpoints.load_serving_checkpoint(ours / name)[1])
    got = jax.tree_util.tree_leaves(ours_tree)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    theirs_tree = weights.torch_to_flax(params)
    for a, b in zip(jax.tree_util.tree_leaves(theirs_tree), got):
        np.testing.assert_array_equal(a, b)
    # the EMA of the newest full checkpoint
    tree = checkpoints.read_checkpoint(ours / "checkpoints" /
                                       "step_00002.msgpack")
    for a, b in zip(jax.tree_util.tree_leaves(tree["ema_params"]), got):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_export_serving_without_a_checkpoint(tmp_path, capsys):
    (tmp_path / "checkpoints").mkdir()
    assert export_serving.main(["--workdir", str(tmp_path)]) == 1
    assert "no full checkpoint" in capsys.readouterr().out


def test_export_samples_writes_jax_names_and_sidecar(runs, tmp_path):
    kwargs = dict(num_clips=2, bits=8)
    ref = j_export.export_samples(runs["audio"], out_dir=tmp_path / "jax",
                                  **kwargs)
    got = export_samples.export_samples(runs["audio"],
                                        out_dir=tmp_path / "port",
                                        device="cpu", **kwargs)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "bitstream_0_original.wav" in names
    assert "heldout_1_recon_nfe1.wav" in names
    assert list(got) == list(ref)
    for section in ("heldout", "bitstream"):
        assert [list(r) for r in got[section]] == [list(r) for r in
                                                   ref[section]]
    assert [r["kbps_measured"] for r in got["bitstream"]] == [
        r["kbps_measured"] for r in ref["bitstream"]]
    on_disk = json.loads((tmp_path / "port" / "export_samples.json")
                         .read_text())
    assert on_disk["num_clips"] == 2 and on_disk["frame_size"] == 2048


def test_export_samples_cli_skips_the_bitstream(runs, tmp_path):
    out = tmp_path / "out"
    assert export_samples.main(["--workdir", str(runs["audio"]),
                                "--num-clips", "1", "--skip-bitstream",
                                "--out-dir", str(out), "--device",
                                "cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "export_samples.json", "heldout_0_original.wav",
        "heldout_0_recon_nfe1.wav"]


def test_export_samples_asks_for_the_card(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        export_samples.export_samples(runs["audio"], num_clips=1)


# ---------------------------------------------------------------------------
# results tables and config tools: the same bytes
# ---------------------------------------------------------------------------


def _same_tree(a: Path, b: Path) -> int:
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return len(files)


SOURCE_CSVS = ["outputs/ablations/metrics.csv",
               "outputs/matrix_mnist/metrics.csv"]


@pytest.mark.parametrize("source", SOURCE_CSVS)
def test_aggregate_results_writes_jax_bytes(source, tmp_path):
    argv = ["--csv", str(REPO / source), "--group-by", "method", "nfe"]
    assert j_aggregate.main(argv + ["--out", str(tmp_path / "j.csv")]) == 0
    assert aggregate_results.main(argv + ["--out",
                                          str(tmp_path / "p.csv")]) == 0
    assert (tmp_path / "p.csv").read_bytes() == (
        tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("source", SOURCE_CSVS)
def test_generate_tables_writes_jax_bytes(source, tmp_path):
    argv = ["--csv", str(REPO / source)]
    j_tables.main(argv + ["--out-dir", str(tmp_path / "j")])
    generate_tables.main(argv + ["--out-dir", str(tmp_path / "p")])
    assert _same_tree(tmp_path / "j", tmp_path / "p") > 0


def test_curated_tables_write_jax_bytes(tmp_path):
    argv = ["--curated", "--root", str(REPO)]
    j_tables.main(argv + ["--out-dir", str(tmp_path / "j")])
    generate_tables.main(argv + ["--out-dir", str(tmp_path / "p")])
    assert _same_tree(tmp_path / "j", tmp_path / "p") > 0


def test_ablation_tables_write_jax_bytes(tmp_path):
    argv = ["--csv", str(REPO / "outputs/ablations/metrics.csv")]
    assert j_ablation.main(argv + ["--out-dir", str(tmp_path / "j")]) == 0
    assert ablation_tables.main(argv + ["--out-dir",
                                        str(tmp_path / "p")]) == 0
    assert _same_tree(tmp_path / "j", tmp_path / "p") > 0
    assert ablation_tables.parse_knob("ablation--no_stop_gradient") == (
        "stop_gradient", "False")


@pytest.mark.parametrize("extra", [[], ["--no-ablations",
                                        "--workdir-root", "./runs/x"]],
                         ids=["all", "matrix-only"])
def test_generate_configs_writes_jax_bytes(extra, tmp_path):
    assert j_generate.main(["--out-dir", str(tmp_path / "j")] + extra) == 0
    assert generate_configs.main(["--out-dir", str(tmp_path / "p")]
                                 + extra) == 0
    assert _same_tree(tmp_path / "j", tmp_path / "p") == (
        48 if extra else 72)


def test_migrate_configs_writes_jax_bytes(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    flat = {"batch_size": 16, "n_steps": 50, "base_lr": 1e-3,
            "weight_decay": 0.0, "seed": 1, "noise_dimension": 784,
            "condition_dimension": 64, "latent_dimension": 32,
            "num_blocks": 2, "dataset": "mnist", "sample_every": 10,
            "sample_seed": 0, "sample_steps": 5, "workdir": "/tmp/v1"}
    (src / "v1.json").write_text(json.dumps(flat))
    (src / "v1_gamma.json").write_text(json.dumps(dict(flat, gamma=0.5,
                                                       method="mean_flow")))
    shutil.copy(REPO / "configs" / "frontier_v2.json", src / "v2.json")
    assert j_migrate.main([str(src), "--out-dir", str(tmp_path / "j")]) == 0
    jax_out = capsys.readouterr().out
    assert migrate_configs.main([str(src), "--out-dir",
                                 str(tmp_path / "p")]) == 0
    assert capsys.readouterr().out == jax_out.replace(
        "meanflow_audio_codec_tpu", "meanflow_audio_codec_torch")
    assert _same_tree(tmp_path / "j", tmp_path / "p") == 3
    assert "2/3 files migrated" in jax_out
