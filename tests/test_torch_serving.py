"""PyTorch port: serving a trained run (``AudioCodec.from_workdir``, the
byte API, the codec CLI, file input) against the JAX package.

Two tiny workdirs (W=64 stereo, 128-wide rows, two ConvNeXt stages, float32):
one written by the JAX package's own checkpoint writers from seeded weights
(EMA different from the live parameters), one by the port's trainer (2
steps, EMA 0.99). The JAX decode draws its start noise as
``jax.random.normal(key, (B*nf, noise_dim))``; the port gets that array as
``noise=``.

Tolerances: audio through the codec at float32 rtol/atol 1e-4 (the codec
tolerance of tests/test_torch_codec.py); weights, bytes, codes and the
port's in-memory against from-bytes decode: bit for bit.
"""

import json
import shutil
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.codec import AudioCodec as JaxAudioCodec
from meanflow_audio_codec_tpu.configs import TrainFlowConfig
from meanflow_audio_codec_tpu.data import audio as jax_audio
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import (
    TrainState as JaxTrainState,
)
from meanflow_audio_codec_tpu.tools import codec_cli as jax_cli
from meanflow_audio_codec_tpu.training import checkpoints as jckpt
from meanflow_audio_codec_tpu.training.trainer import (
    make_optimizer as jax_make_optimizer,
)
from meanflow_audio_codec_torch import serialization, weights
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.data import audio as port_audio
from meanflow_audio_codec_torch.ops import latent_quant as lq
from meanflow_audio_codec_torch.tools import codec_cli
from meanflow_audio_codec_torch.training import checkpoints
from meanflow_audio_codec_torch.training.trainer import train_flow

WINDOW, HOP, NOISE, FRAME = 64, 32, 128, 2048
TOL = dict(rtol=1e-4, atol=1e-4)

TINY = {
    "config_version": "2.0",
    "base": {"batch_size": 2, "n_steps": 2, "base_lr": 1e-3,
             "weight_decay": 1e-4, "seed": 3},
    "model": {"noise_dimension": NOISE, "condition_dimension": 16,
              "latent_dimension": 8, "num_blocks": 2,
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
                 "workdir": "unset", "checkpoint_step": 2,
                 "max_checkpoints_to_keep": 2, "ema_decay": 0.99},
    "tpu": {"precision": "float32", "steps_per_call": 2,
            "skip_nonfinite_updates": True},
}


def _tiny(workdir):
    data = json.loads(json.dumps(TINY))
    data["training"]["workdir"] = str(workdir)
    return data


def _jax_workdir(workdir, step=3):
    """A run directory written by the JAX package's writers: config.json,
    step_N.msgpack with its sidecar, serving_step_N.msgpack."""
    jcfg = TrainFlowConfig.from_dict(_tiny(workdir))
    model = jax_create_flow_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, NOISE)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(4)

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda a: (scale * rng.standard_normal(a.shape)).astype(
                np.float32), shapes)

    state = JaxTrainState.create(apply_fn=model.apply, params=draw(0.2),
                                 tx=jax_make_optimizer(jcfg),
                                 ema_params=draw(0.2), ema_decay=0.99)
    state = state.replace(step=step)
    workdir.mkdir(parents=True)
    (workdir / "config.json").write_text(json.dumps(jcfg.to_dict()))
    jckpt.save_checkpoint_with_metadata(state, workdir / "checkpoints",
                                        step=step, config=jcfg)
    jckpt.save_serving_checkpoint(state, workdir / "checkpoints", step=step)
    return workdir


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    train_flow(config_from_dict(_tiny(root / "port")), device="cpu")
    return {"jax": _jax_workdir(root / "jax"), "port": root / "port"}


@pytest.fixture(scope="module")
def codecs(workdirs):
    """(JAX codec, port codec) serving each workdir."""
    return {name: (JaxAudioCodec.from_workdir(path),
                   AudioCodec.from_workdir(path, device="cpu"))
            for name, path in workdirs.items()}


def _audio(batch=2, length=FRAME, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 44100.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)[None, :, None]
    return (tone + 0.2 * rng.standard_normal((batch, length, 2))).astype(
        np.float32)


def _noise(rows, seed=0):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.normal(key, (rows, NOISE)))


def _full(workdir):
    return sorted(workdir.glob("checkpoints/step_*.msgpack"))[-1]


def _tree(path):
    return serialization.msgpack_restore(path.read_bytes())


def _assert_serves(codec, params):
    got = codec.model.state_dict()
    assert set(got) == set(params)
    for name, value in params.items():
        assert torch.equal(got[name], value), name


# ---------------------------------------------------------------------------
# loading a run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serves_the_ema_of_the_newest_full_checkpoint(workdirs, codecs,
                                                      writer):
    tree = _tree(_full(workdirs[writer]))
    ema = weights.flax_to_torch(tree["ema_params"])
    assert not all(torch.equal(ema[k], v) for k, v in
                   weights.flax_to_torch(tree["params"]).items())
    _assert_serves(codecs[writer][1], ema)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_served_roundtrip_matches_jax(codecs, writer):
    jcodec, codec = codecs[writer]
    audio = _audio()
    nf = (FRAME - WINDOW) // HOP + 1
    key, noise = _noise(2 * nf)
    ref = np.asarray(jcodec.roundtrip(audio, key=key))
    got = codec.roundtrip(audio, noise=noise).numpy()
    assert got.shape == ref.shape == (2, (nf - 1) * HOP + 2 * WINDOW, 2)
    np.testing.assert_allclose(got, ref, **TOL)


def test_serving_file_alone_serves_the_same_weights(workdirs, codecs,
                                                    tmp_path):
    restored = tmp_path / "restored"
    shutil.copytree(workdirs["port"], restored)
    for path in restored.glob("checkpoints/step_*"):
        path.unlink()
    codec = AudioCodec.from_workdir(restored, device="cpu")
    step, served = checkpoints.load_serving_checkpoint(
        checkpoints.find_latest_serving_checkpoint(restored / "checkpoints"))
    assert step == 2
    _assert_serves(codec, served)
    _assert_serves(codec, codecs["port"][1].model.state_dict())
    audio = _audio(seed=2)
    key, noise = _noise(2 * ((FRAME - WINDOW) // HOP + 1))
    np.testing.assert_allclose(
        codec.roundtrip(audio, noise=noise).numpy(),
        np.asarray(JaxAudioCodec.from_workdir(restored).roundtrip(audio,
                                                                  key=key)),
        **TOL)


def test_a_full_checkpoint_wins_over_a_newer_serving_file(workdirs,
                                                          tmp_path):
    """As in the JAX package: the newest full checkpoint is served while
    one exists, even when a serving file of a higher step is present."""
    workdir = tmp_path / "mixed"
    shutil.copytree(workdirs["port"], workdir)
    tree = _tree(_full(workdir))
    newer = workdir / "checkpoints" / "serving_step_00009.msgpack"
    newer.write_bytes(serialization.msgpack_serialize(
        {"step": 9, "params": tree["params"]}))
    assert checkpoints.find_latest_serving_checkpoint(
        workdir / "checkpoints") == newer
    assert checkpoints.find_latest_checkpoint(workdir / "checkpoints") == (
        _full(workdir))
    _assert_serves(AudioCodec.from_workdir(workdir, device="cpu"),
                   weights.flax_to_torch(tree["ema_params"]))
    jparams = JaxAudioCodec.from_workdir(workdir).params
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(tree["ema_params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_workdir_without_checkpoints_raises(workdirs, tmp_path):
    workdir = tmp_path / "empty"
    (workdir / "checkpoints").mkdir(parents=True)
    shutil.copy(workdirs["port"] / "config.json", workdir)
    assert checkpoints.find_latest_checkpoint(workdir / "checkpoints") is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        AudioCodec.from_workdir(workdir, device="cpu")
    with pytest.raises(FileNotFoundError):
        JaxAudioCodec.from_workdir(workdir)


def test_quantized_serving_names_its_roadmap_item(workdirs):
    """W8A8 int8 serving (refused, naming its ROADMAP item, until it was
    ported): the JAX-written run served quantized by both packages from the
    same checkpoint gives the same round trip at the codec tolerance, within
    0.05 of the unquantized one; config.json is left as it was."""
    workdir = workdirs["jax"]
    on_disk = (workdir / "config.json").read_text()
    codec = AudioCodec.from_workdir(workdir, device="cpu", quantized=True)
    assert codec.model.stages[0].block.conv.quantized
    assert not codec.model.encoder.head.quantized
    audio = _audio()
    nf = (FRAME - WINDOW) // HOP + 1
    key, noise = _noise(2 * nf)
    ref = np.asarray(JaxAudioCodec.from_workdir(
        workdir, quantized=True).roundtrip(audio, key=key))
    got = codec.roundtrip(audio, noise=noise).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    plain = AudioCodec.from_workdir(workdir, device="cpu").roundtrip(
        audio, noise=noise).numpy()
    rel = np.linalg.norm(got - plain) / np.linalg.norm(plain)
    assert 1e-4 < rel < 0.05
    assert (workdir / "config.json").read_text() == on_disk


def test_a_qat_run_serves_in_both_packages(workdirs, tmp_path):
    workdir = tmp_path / "qat"
    shutil.copytree(workdirs["jax"], workdir)
    config = json.loads((workdir / "config.json").read_text())
    config["method"].update(qat_mode="ste", qat_step_frac=0.5)
    (workdir / "config.json").write_text(json.dumps(config))
    codec = AudioCodec.from_workdir(workdir, device="cpu")
    assert codec.config.qat_mode == "ste"
    audio = _audio(batch=1, seed=6)
    key, noise = _noise((FRAME - WINDOW) // HOP + 1)
    np.testing.assert_allclose(
        codec.roundtrip(audio, noise=noise).numpy(),
        np.asarray(JaxAudioCodec.from_workdir(workdir).roundtrip(audio,
                                                                 key=key)),
        **TOL)


def test_metadata_matches_jax(codecs):
    jcodec, codec = codecs["port"]
    assert codec._hop == jcodec._hop == HOP
    assert codec._channels == jcodec._channels == 2
    assert codec.frames_per_second == jcodec.frames_per_second
    assert codec.compression_ratio == jcodec.compression_ratio
    for bits in (4, 8, 16):
        assert codec.bitrate_kbps(bits) == jcodec.bitrate_kbps(bits)


# ---------------------------------------------------------------------------
# the byte API
# ---------------------------------------------------------------------------

FORMATS = {"v1-8bit": dict(bits=8), "v1-4bit": dict(bits=4),
           "v2-ecsq": dict(step_frac=0.5)}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_bytes_written_by_either_package_decode_in_the_other(codecs, fmt):
    jcodec, codec = codecs["port"]
    kwargs = FORMATS[fmt]
    audio = _audio(seed=3)
    key, noise = _noise(2 * ((FRAME - WINDOW) // HOP + 1), seed=5)
    for data in (jcodec.encode_bytes(audio, **kwargs),
                 codec.encode_bytes(audio, **kwargs)):
        assert lq.describe_bitstream(data)["gain_shape"]
        ref = np.asarray(jcodec.decode_bytes(data, key=key))
        got = codec.decode_bytes(data, noise=noise).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_in_memory_decode_equals_from_bytes(codecs, fmt):
    _, codec = codecs["jax"]
    audio = _audio(seed=4)
    stream = codec.encode_packed(audio, **FORMATS[fmt])
    data = codec.encode_bytes(audio, **FORMATS[fmt])
    assert data == lq.pack_bitstream(stream)
    # the gains ride the 8-bit log grid the bytes carry
    np.testing.assert_array_equal(
        stream.gains.numpy(),
        lq.dequantize_gains(lq.quantize_gains(stream.gains.numpy())))
    a = codec.decode_packed(stream,
                            generator=torch.Generator().manual_seed(3))
    b = codec.decode_bytes(data, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert torch.equal(codec.decode_bytes(data), codec.decode_bytes(data))


def test_ecsq_is_rans_coded_below_the_raw_rate(codecs):
    _, codec = codecs["port"]
    audio = _audio(batch=1, length=8 * FRAME, seed=7)
    data = codec.encode_bytes(audio, step_frac=1.0)
    assert lq.describe_bitstream(data)["coding"] == "rANS"
    raw = lq.pack_bitstream(codec.encode_packed(audio, step_frac=1.0),
                            entropy=False)
    assert len(data) < len(raw)


# ---------------------------------------------------------------------------
# WAV input and the CLI
# ---------------------------------------------------------------------------


def _write_pcm(path, samples, rate, width):
    """Interleaved samples (T, C) in [-1, 1) as a PCM WAV of ``width``
    bytes per sample."""
    if width == 1:
        pcm = np.round(samples * 127 + 128).astype(np.uint8)
    elif width == 2:
        pcm = np.round(samples * 32767).astype(np.int16)
    else:
        pcm = np.round(samples * 2.0**31 * 0.99).astype(np.int32)
    with wave.open(str(path), "wb") as wav:
        wav.setnchannels(samples.shape[1])
        wav.setsampwidth(width)
        wav.setframerate(rate)
        wav.writeframes(pcm.tobytes())


@pytest.mark.parametrize("width,channels,rate", [
    (2, 2, 44100), (1, 1, 44100), (4, 2, 44100), (2, 1, 48000),
    (2, 2, 22050)])
def test_wav_input_matches_jax(tmp_path, width, channels, rate):
    rng = np.random.default_rng(width + channels)
    path = tmp_path / "in.wav"
    _write_pcm(path, rng.uniform(-0.9, 0.9, (3000, channels)), rate, width)
    got = port_audio.load_audio_file(path, resample=True)
    ref = jax_audio.load_audio_file(path, resample=True)
    assert got.shape == ref.shape and got.shape[0] == 2
    np.testing.assert_array_equal(got, ref)
    if rate != 44100:
        with pytest.warns(UserWarning, match="sample rate"):
            assert port_audio.load_audio_file(path) is None


def test_unported_and_unknown_input_types(tmp_path):
    """The four types the WAV-only loader used to refuse (AIFF under both
    extensions, FLAC, and MP3 headers without a decodable payload) decode
    as the JAX package decodes them, bit for bit; an unknown type and a
    broken WAV give None in both."""
    from meanflow_audio_codec_tpu.data import flac_write as jax_flac

    rng = np.random.default_rng(12)
    pcm = rng.integers(-30000, 30000, size=(2, 3000))
    jax_flac.write_flac(tmp_path / "song.flac", pcm, mode="fixed2",
                        stereo="mid_side")
    aiff = (b"FORM" + (4 + 8 + 18 + 8 + 8 + 4 * 3000).to_bytes(4, "big")
            + b"AIFF" + b"COMM" + (18).to_bytes(4, "big")
            + (2).to_bytes(2, "big") + (3000).to_bytes(4, "big")
            + (16).to_bytes(2, "big") + b"\x40\x0e\xac\x44" + bytes(6)
            + b"SSND" + (8 + 4 * 3000).to_bytes(4, "big") + bytes(8)
            + pcm.T.astype(">i2").tobytes())
    for suffix in (".aiff", ".aif"):
        (tmp_path / f"song{suffix}").write_bytes(aiff)
    (tmp_path / "song.mp3").write_bytes(b"\x00\x01\x02\x03" * 100)
    for name in ("song.flac", "song.aiff", "song.aif"):
        got = port_audio.load_audio_file(tmp_path / name)
        ref = jax_audio.load_audio_file(tmp_path / name)
        assert got.shape == (2, 3000), name
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(np.round(got * 32768), pcm)
    assert port_audio.load_audio_file(tmp_path / "song.mp3") is None
    assert jax_audio.load_audio_file(tmp_path / "song.mp3") is None
    assert port_audio.load_audio_file(tmp_path / "song.ogg") is None
    broken = tmp_path / "broken.wav"
    broken.write_bytes(b"RIFF\x00\x00")
    with pytest.warns(UserWarning, match="Failed to decode"):
        assert port_audio.load_audio_file(broken) is None


@pytest.fixture(scope="module")
def wav_48k(tmp_path_factory):
    """A stereo WAV at 48 kHz, so the CLI's resampler runs."""
    path = tmp_path_factory.mktemp("cli") / "song.wav"
    rng = np.random.default_rng(11)
    _write_pcm(path, rng.uniform(-0.5, 0.5, (2400, 2)), 48000, 2)
    return path


def _info(main, path, capsys):
    assert main(["info", str(path)]) == 0
    return capsys.readouterr().out


def test_cli_files_cross_between_packages(workdirs, codecs, wav_48k,
                                          tmp_path, capsys):
    workdir = str(workdirs["port"])
    _, codec = codecs["port"]
    for name, (enc, dec) in {"jax->port": (jax_cli.main, codec_cli.main),
                             "port->jax": (codec_cli.main, jax_cli.main)
                             }.items():
        macb, out = tmp_path / f"{name}.macb", tmp_path / f"{name}.wav"
        device = ["--device", "cpu"]
        assert enc(["encode", str(wav_48k), "--workdir", workdir, "-o",
                    str(macb), "--bits", "4"]
                   + (device if enc is codec_cli.main else [])) == 0
        line = capsys.readouterr().out
        assert f"-> {macb} ({macb.stat().st_size} bytes" in line
        assert _info(codec_cli.main, macb, capsys) == _info(jax_cli.main,
                                                            macb, capsys)
        assert dec(["decode", str(macb), "--workdir", workdir, "-o",
                    str(out), "--seed", "2"]
                   + (device if dec is codec_cli.main else [])) == 0
        assert "nfe=1" in capsys.readouterr().out
        recon = port_audio.load_audio_file(out)
        n_in = 2400 * 44100 // 48000
        assert n_in <= recon.shape[1] <= n_in + 2 * WINDOW + HOP
        assert np.isfinite(recon).all()
        if dec is codec_cli.main:  # the CLI's --seed seeds the generator
            want = codec.decode_bytes(
                macb.read_bytes(),
                generator=torch.Generator().manual_seed(2))[0].numpy()
            pcm = (np.clip(want, -1, 1) * 32767).astype(np.int16) / 32768.0
            np.testing.assert_array_equal(recon.T, pcm.astype(np.float32))


def test_cli_info_and_refusals(workdirs, tmp_path, capsys):
    garbage = tmp_path / "x.macb"
    garbage.write_bytes(b"nope")
    with pytest.raises(SystemExit, match="not a MACB"):
        codec_cli.main(["info", str(garbage)])
    good = tmp_path / "ones.macb"
    good.write_bytes(lq.pack_bitstream(lq.quantize_latents(
        torch.ones(1, 2, 8))))
    assert "MACB v1, 8-bit raw codes (symmetric), batch=1 frames=2 " \
           "latent_dim=8" in _info(codec_cli.main, good, capsys)
    # decode --quantized serves the int8 decoder, seeded as without it
    out = tmp_path / "q.wav"
    assert codec_cli.main(["decode", str(good), "--workdir",
                           str(workdirs["port"]), "--quantized", "--device",
                           "cpu", "-o", str(out), "--seed", "2"]) == 0
    want = AudioCodec.from_workdir(
        workdirs["port"], device="cpu", quantized=True).decode_bytes(
        good.read_bytes(), generator=torch.Generator().manual_seed(2))[0]
    pcm = (np.clip(want.numpy(), -1, 1) * 32767).astype(np.int16) / 32768.0
    np.testing.assert_array_equal(port_audio.load_audio_file(out).T,
                                  pcm.astype(np.float32))
