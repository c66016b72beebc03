"""PyTorch port: ``ComprehensiveEvaluator`` and ``count_parameters`` against
the JAX package's, on checkpoints JAX's own ``train_flow`` writes.

Two runs, 2 steps each: synthetic MNIST with the reshape tokenizer (the
recipe of tests/test_evaluators.py: an MLP flow, latent 4) and a small
audio MDCT ConvNeXt codec (W=64 stereo, frame 12288 so that STOI, eSTOI and
NSIM have frames enough, gain-normalised, float32). Both packages evaluate
the same checkpoint on the same numpy data at NFE {1, 2}, from float
latents, fixed 8-bit codes and the ECSQ 0.5 format. The JAX evaluator
draws each NFE's start noise as ``normal(sub, (rows, noise_dim))`` with
``sub`` split from ``PRNGKey(0)``; the port gets those arrays as
``noise=``. This file holds the audio run and the shared helpers; the
MNIST run's tests are in tests/test_torch_evaluator_images.py.

Tolerances: every metric of an NFE entry rtol 1e-4 (the port's metric code
is the JAX package's numpy code; the decoded samples agree to float32
rounding), ``si_snr_db`` atol 1e-3 dB; the rANS-coded
``bitstream_kbps_measured`` and the parameter counts (total and by
top-level module) equal; the result dicts' keys (top level, per entry,
``inference``) equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.data.mnist import load_mnist
from meanflow_audio_codec_tpu.evaluators import (
    ComprehensiveEvaluator as JaxEvaluator,
)
from meanflow_audio_codec_tpu.evaluators import (
    count_parameters as jax_count_parameters,
)
from meanflow_audio_codec_tpu.training.checkpoints import (
    find_latest_checkpoint,
)
from meanflow_audio_codec_tpu.training.trainer import train_flow
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.evaluators import (
    ComprehensiveEvaluator,
    count_parameters,
)

NFES = [1, 2]
RTOL = 1e-4
SNR_ATOL = 1e-3
FRAME, WINDOW = 12288, 64

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
AUDIO = {
    "base": {"batch_size": 2, "n_steps": 2, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3},
    "model": {"noise_dimension": 2 * WINDOW, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 1,
              "architecture": "convnet",
              "architecture_options": {"channels": 16, "bottleneck_dim": 32,
                                       "spatial": 4, "lift_channels": 8}},
    "dataset": {"dataset": "audio", "tokenization_strategy": "mdct",
                "tokenization_config": {
                    "frame_size": FRAME, "window_size": WINDOW,
                    "coeff_scale": 4.0, "gain_norm": 0.05,
                    "device_pool_clips": 4, "synthetic_family": "mixed"}},
    "method": {"method": "improved_mean_flow",
               "use_improved_mean_flow": True},
    "training": {"sample_every": 1000, "sample_seed": 1, "sample_steps": 1,
                 "checkpoint_step": 2, "ema_decay": 0.99},
    "tpu": {"precision": "float32", "steps_per_call": 2},
}
RUNS = {"mnist": MNIST, "audio": AUDIO}
#: the passes: float latents, fixed 8-bit codes, ECSQ at step 0.5
PASSES = {"float": {}, "bits8": {"latent_bits": 8},
          "ecsq0.5": {"latent_step": 0.5}}


def eval_data(name: str) -> np.ndarray:
    if name == "mnist":
        return next(load_mnist(batch_size=8)[1])
    rng = np.random.default_rng(5)
    t = np.arange(FRAME) / 44100.0
    tone = 0.3 * np.sin(2 * np.pi * 330.0 * t)[None, :, None]
    return (tone + 0.1 * rng.standard_normal((2, FRAME, 2))).astype(
        np.float32)


def train_run(name: str, workdir) -> tuple:
    """(JAX config, port config, the checkpoint JAX's train_flow writes)."""
    data = json.loads(json.dumps(RUNS[name]))
    data["training"]["workdir"] = str(workdir)
    jcfg = TrainFlowConfig.from_dict(data)
    train_flow(jcfg)
    checkpoint = find_latest_checkpoint(jcfg.workdir / "checkpoints")
    return jcfg, config_from_dict(jcfg.to_dict()), checkpoint


def jax_noise(rows: int, noise_dim: int) -> dict:
    """JAX's draws of each NFE's start noise (evaluator seed 0)."""
    key, noise = jax.random.PRNGKey(0), {}
    for nfe in NFES:
        key, sub = jax.random.split(key)
        noise[nfe] = torch.from_numpy(np.array(jax.random.normal(
            sub, (rows, noise_dim), dtype=np.float32)))
    return noise


def evaluate_both(name: str, run: tuple) -> dict:
    """pass -> (JAX results, port results) of one run at NFE {1, 2}."""
    jcfg, cfg, checkpoint = run
    data = eval_data(name)
    out = {}
    for label, kwargs in PASSES.items():
        common = dict(nfe_list=NFES, num_samples=len(data),
                      batch_size=len(data), timing_runs=1, **kwargs)
        ref = JaxEvaluator(checkpoint, jcfg, **common).evaluate(data)
        port = ComprehensiveEvaluator(checkpoint, cfg, device="cpu", **common)
        rows = (len(data) * port.token_shape[0] if name == "audio"
                else len(data))
        got = port.evaluate(data, noise=jax_noise(rows, port.noise_dim))
        out[label] = (ref, got)
    return out


def check_keys(name: str, ref: dict, got: dict) -> None:
    """The port's result dict has JAX's keys: top level, per NFE entry and
    in ``inference``."""
    assert list(got) == list(ref)
    assert list(got["nfe_sweep"]) == [str(n) for n in NFES]
    for nfe in got["nfe_sweep"]:
        entry, want = got["nfe_sweep"][nfe], ref["nfe_sweep"][nfe]
        assert set(entry) == set(want)
        assert set(entry["inference"]) == set(want["inference"])
        assert entry["inference"]["runs"] == 1
        assert entry["nfe"] == want["nfe"] == int(nfe)
    metrics = set(got["nfe_sweep"]["1"])
    if name == "audio":
        assert {"spectral_distance", "si_snr_db", "stoi", "estoi",
                "intelligibility_pct", "nsim", "bsd"} <= metrics
    else:
        assert {"psnr_db", "ssim", "fid_pixel", "kid_pixel"} <= metrics


def check_metrics(ref: dict, got: dict) -> None:
    """Every metric of every NFE entry within the stated tolerance, and the
    parameter count equal."""
    assert got["param_count"] == ref["param_count"]
    for nfe, want in ref["nfe_sweep"].items():
        entry = got["nfe_sweep"][nfe]
        for metric, value in want.items():
            if metric in ("nfe", "first_call_sec", "inference"):
                continue
            tol = (dict(atol=SNR_ATOL, rtol=0) if metric == "si_snr_db"
                   else dict(rtol=RTOL, atol=1e-7))
            np.testing.assert_allclose(entry[metric], value,
                                       err_msg=f"{nfe} {metric}", **tol)
            assert np.isfinite(entry[metric])


def check_parameter_counts(run: tuple) -> None:
    """``param_info`` and ``count_parameters`` of the model: JAX's total and
    top-level modules."""
    jcfg, cfg, checkpoint = run
    evaluator = ComprehensiveEvaluator(checkpoint, cfg, nfe_list=[1],
                                       device="cpu")
    ref = jax_count_parameters(JaxEvaluator(checkpoint, jcfg).state.params)
    assert evaluator.param_info == ref
    assert count_parameters(evaluator.model) == ref
    assert sum(ref["by_module"].values()) == ref["total"] > 0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return train_run("audio", tmp_path_factory.mktemp("audio"))


@pytest.fixture(scope="module")
def evaluations(run):
    return evaluate_both("audio", run)


@pytest.mark.parametrize("label", list(PASSES))
def test_result_keys_match_jax(evaluations, label):
    check_keys("audio", *evaluations[label])


@pytest.mark.parametrize("label", list(PASSES))
def test_metrics_match_jax(evaluations, label):
    check_metrics(*evaluations[label])


@pytest.mark.parametrize("label", ["bits8", "ecsq0.5"])
def test_stored_format_kbps_equals_jax(evaluations, label):
    ref, got = evaluations[label]
    key = "latent_bits" if label == "bits8" else "latent_step"
    assert got[key] == ref[key]
    assert got["bitstream_kbps_measured"] == ref["bitstream_kbps_measured"]
    assert got["bitstream_kbps_measured"] > 0


def test_parameter_counts_match_jax(run):
    check_parameter_counts(run)


def test_evaluator_samples_with_the_ema(run):
    """The sampling model holds the checkpoint's EMA, not its live
    parameters (both differ after two steps)."""
    _, cfg, checkpoint = run
    evaluator = ComprehensiveEvaluator(checkpoint, cfg, device="cpu")
    live = list(evaluator.state.model.parameters())
    used = list(evaluator.model.parameters())
    assert all(torch.equal(u, e) for u, e in zip(used, evaluator.state.ema))
    assert not all(torch.equal(u, p) for u, p in zip(used, live))


def test_evaluator_draws_its_own_noise_reproducibly(run):
    """Without ``noise`` each NFE's start draws from a generator seeded with
    ``seed``: two evaluations agree, another seed does not."""
    _, cfg, checkpoint = run
    data = eval_data("audio")

    def mse(seed):
        results = ComprehensiveEvaluator(
            checkpoint, cfg, nfe_list=[1], timing_runs=0, seed=seed,
            device="cpu").evaluate(data)
        entry = results["nfe_sweep"]["1"]
        assert entry["inference"]["runs"] == 0
        return entry["mse"]

    assert mse(0) == mse(0) != mse(1)


def test_evaluator_asks_for_the_card(run, monkeypatch):
    _, cfg, checkpoint = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ComprehensiveEvaluator(checkpoint, cfg)


def test_save_results_writes_json(evaluations, run, tmp_path):
    _, got = evaluations["float"]
    _, cfg, checkpoint = run
    path = tmp_path / "out" / "evaluation_results.json"
    ComprehensiveEvaluator(checkpoint, cfg, device="cpu").save_results(got,
                                                                       path)
    assert json.loads(path.read_text())["nfe_sweep"]["1"]["mse"] == (
        got["nfe_sweep"]["1"]["mse"])
