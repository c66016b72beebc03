"""PyTorch port: ``train_flow(device="cpu")`` on the new families, with a
resume — MNIST + reshape + MLP (features layout, PNG samples) and audio +
MDCT + MLP-Mixer (frames layout, WAV samples): the log, the samples, the
checkpoints, and the JAX package's ``load_flow_state`` reading the port's
checkpoint. Then the audio + MDCT runs of the MLP and the mixer served by
``AudioCodec.from_workdir`` in both packages: the round trip with JAX's
noise, and MACB bytes written by either package decoded by the other (the
mixer's ``[rows, tokens, latent]`` latents travel as ``[B, nf,
tokens*latent]``, as in the JAX codec), at rtol 1e-4 / atol 1e-4, the
tolerance of tests/test_torch_serving.py (float32 models; the decode's
MDCT synthesis sums 2W products per sample).
"""

import json

import jax
import numpy as np
import pytest

from meanflow_audio_codec_tpu.codec import AudioCodec as JaxAudioCodec
from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.training.trainer import (
    load_flow_state as jax_load_flow_state,
)
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.ops import latent_quant as lq
from meanflow_audio_codec_torch.training.logging import read_log
from meanflow_audio_codec_torch.training.trainer import train_flow

from test_torch_families_train import AUDIO_FRAME, MIXER_OPTIONS, WINDOW
from test_torch_families_train import _config

RUNS = {
    "mnist_reshape_mlp": ("mlp", {}, "mnist", "reshape", {}),
    "audio_mdct_mixer": ("mlp_mixer", MIXER_OPTIONS, "audio", "mdct",
                         {"frame_size": AUDIO_FRAME, "window_size": WINDOW,
                          "coeff_scale": 4.0, "gain_norm": 0.05,
                          "device_pool_clips": 4}),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_train_flow_with_resume(run, tmp_path):
    workdir = tmp_path / "run"
    data = _config(*RUNS[run], workdir=workdir, sample_every=2,
                   checkpoint_step=2, max_checkpoints_to_keep=2)
    data["tpu"]["steps_per_call"] = 2
    data["base"]["n_steps"] = 2
    train_flow(config_from_dict(data), device="cpu")
    data["base"]["n_steps"] = 4
    summary = train_flow(config_from_dict(data), resume=True, device="cpu")
    records = read_log(workdir / "logs" / "train_log.jsonl")
    steps = [r for r in records if "event" not in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["update_ok"] for r in steps)
    assert np.isfinite(summary["loss"]["final"])
    samples = sorted(p.name for p in (workdir / "samples").iterdir()
                     if p.name.startswith("step_"))
    ext = "png" if "mnist" in run else "wav"
    assert samples == [f"step_00002.{ext}", f"step_00004.{ext}"]
    checkpoint = workdir / "checkpoints" / "step_00004.msgpack"
    assert checkpoint.exists()
    # the JAX package serves the port's checkpoint
    jcfg = TrainFlowConfig.from_dict(json.loads(
        (workdir / "config.json").read_text()))
    jstate, _ = jax_load_flow_state(checkpoint, jcfg)
    assert int(jstate.step) == 4


SERVE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family,options", [("mlp", {}),
                                            ("mlp_mixer", MIXER_OPTIONS)])
def test_audio_run_serves_in_both_packages(family, options, tmp_path):
    workdir = tmp_path / "run"
    data = _config(family, options, "audio", "mdct",
                   {"frame_size": AUDIO_FRAME, "window_size": WINDOW,
                    "coeff_scale": 4.0, "gain_norm": 0.05,
                    "device_pool_clips": 4}, workdir=workdir)
    data["base"]["n_steps"] = 2
    train_flow(config_from_dict(data), device="cpu")
    codec = AudioCodec.from_workdir(workdir, device="cpu")
    jcodec = JaxAudioCodec.from_workdir(workdir)
    rng = np.random.default_rng(1)
    audio = (0.3 * rng.standard_normal((2, 4 * AUDIO_FRAME, 2))).astype(
        np.float32)
    latents, _ = codec.encode_with_gains(audio)
    nf = latents.shape[1]
    width = (options.get("num_latent_tokens", 1) * 8)
    assert tuple(latents.shape) == (2, nf, width)
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, (2 * nf, 2 * WINDOW)))
    ref = np.asarray(jcodec.roundtrip(audio, key=key))
    got = codec.roundtrip(audio, noise=noise).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **SERVE_TOL)
    for data in (jcodec.encode_bytes(audio, bits=8),
                 codec.encode_bytes(audio, bits=8)):
        assert lq.describe_bitstream(data)["gain_shape"]
        np.testing.assert_allclose(codec.decode_bytes(data, noise=noise),
                                   np.asarray(jcodec.decode_bytes(data,
                                                                  key=key)),
                                   **SERVE_TOL)
