"""PyTorch port: the whole codec round trip (``AudioCodec.roundtrip``) against
the JAX ``AudioCodec``, at a small geometry (W=64 stereo, 128-wide rows, two
ConvNeXt stages) with ``coeff_scale`` and ``gain_norm`` on.

The JAX codec is built the way ``load_flow_state`` builds it
(``create_flow_model`` + ``init_all`` + ``TrainState.create``); its params
take the tree of ``init_all`` with every leaf redrawn from a seeded numpy
generator so every stage contributes, and the same tree goes to the port via
``weights.flax_to_torch``. The JAX decode draws its start noise as
``jax.random.normal(key, (B*nf, noise_dim))``; the port gets exactly that
array as ``noise=``.

Tolerances: float32 compute at rtol 1e-4 / atol 1e-4 on audio of amplitude
~1 (the f32 model tolerance of test_torch_model.py, with the MDCT's 1e-3
atol tightened because the audio is small); bfloat16 compute at relative L2
<= 2e-2 (bf16 rounding at different points inside fused ops, as in
test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.codec import AudioCodec as JaxAudioCodec
from meanflow_audio_codec_tpu.configs import (
    BaseConfig,
    DatasetConfig,
    MethodConfig,
    ModelConfig,
    TPUConfig,
    TrainFlowConfig,
    TrainingConfig,
)
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import TrainState
from meanflow_audio_codec_tpu.training.trainer import (
    TokenAdapter as JaxTokenAdapter,
    make_optimizer,
)
from meanflow_audio_codec_tpu.ops.tokenize import (
    MDCTTokenization as JaxMDCTTokenization,
)
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops.tokenize import MDCTTokenization
from meanflow_audio_codec_torch.training.adapter import (
    TokenAdapter,
    resolve_flatten_mode,
)
from meanflow_audio_codec_torch.weights import flax_to_torch

WINDOW, HOP, NOISE = 64, 32, 128
FRAME_SIZE = 1024
ARCH = dict(channels=16, spatial=4, lift_channels=8, bottleneck_dim=32)


def _jax_config(precision: str, gain_norm: float = 0.05) -> TrainFlowConfig:
    return TrainFlowConfig(
        base=BaseConfig(batch_size=2, n_steps=1, base_lr=1e-3,
                        weight_decay=0.0, seed=0),
        model=ModelConfig(noise_dimension=NOISE, condition_dimension=16,
                          latent_dimension=8, num_blocks=2,
                          architecture="convnet", architecture_options=ARCH),
        dataset=DatasetConfig(dataset="audio", tokenization_strategy="mdct",
                              tokenization_config={
                                  "frame_size": FRAME_SIZE,
                                  "window_size": WINDOW,
                                  "coeff_scale": 4.0,
                                  "gain_norm": gain_norm,
                              }),
        method=MethodConfig(method="improved_mean_flow",
                            use_improved_mean_flow=True),
        training=TrainingConfig(sample_every=1000, sample_seed=0,
                                sample_steps=1, workdir="unused"),
        tpu=TPUConfig(precision=precision),
    )


def _codecs(precision: str, gain_norm: float = 0.05, seed: int = 0):
    jcfg = _jax_config(precision, gain_norm)
    model = jax_create_flow_model(jcfg)
    variables = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, NOISE)), jnp.zeros((2, 2)),
        method="init_all"))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    state = TrainState.create(apply_fn=model.apply, params=params,
                              tx=make_optimizer(jcfg), ema_params=None)
    jcodec = JaxAudioCodec(state, model, jcfg)
    config = config_from_dict(jcfg.to_dict())
    codec = AudioCodec(create_flow_model(config), flax_to_torch(params),
                       config, device="cpu")
    return jcodec, codec


def _audio(batch=2, length=FRAME_SIZE, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 44100.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)[None, :, None]
    noise = 0.2 * rng.standard_normal((batch, length, 2))
    return (tone + noise).astype(np.float32)


def _noise(batch, length):
    nf = (length - WINDOW) // HOP + 1
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (batch * nf, NOISE)))


@pytest.fixture(scope="module")
def f32_codecs():
    return _codecs("float32")


def test_roundtrip_matches_jax_f32(f32_codecs):
    jcodec, codec = f32_codecs
    audio = _audio()
    ref = np.asarray(jcodec.roundtrip(audio, key=jax.random.PRNGKey(0)))
    got = codec.roundtrip(audio, noise=_noise(2, FRAME_SIZE)).numpy()
    nf = (FRAME_SIZE - WINDOW) // HOP + 1
    assert got.shape == ref.shape == (2, (nf - 1) * HOP + 2 * WINDOW, 2)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_encode_with_gains_matches_jax_f32(f32_codecs):
    jcodec, codec = f32_codecs
    audio = _audio(seed=2)
    jlat, jgains = jcodec.encode_with_gains(audio)
    lat, gains = codec.encode_with_gains(audio)
    np.testing.assert_allclose(gains.numpy(), np.asarray(jgains), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=1e-4,
                               atol=1e-5)


def test_roundtrip_matches_jax_bf16():
    jcodec, codec = _codecs("bfloat16")
    audio = _audio(seed=3)
    ref = np.asarray(jcodec.roundtrip(audio, key=jax.random.PRNGKey(0)))
    got = codec.roundtrip(audio, noise=_noise(2, FRAME_SIZE)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 2e-2


@pytest.mark.parametrize("gain_norm", [0.05, 0.0])
def test_token_adapter_matches_jax(gain_norm):
    audio = _audio(seed=4)
    ours = TokenAdapter(MDCTTokenization(WINDOW), 4.0, gain_norm)
    ref = JaxTokenAdapter(JaxMDCTTokenization(WINDOW, use_pallas=False),
                          "frames", 4.0, gain_norm)
    flat, gains = ours.tokenize_with_gain(torch.from_numpy(audio))
    jflat, jgains = ref.tokenize_with_gain(jnp.asarray(audio))
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gains.numpy(), np.asarray(jgains), rtol=1e-4,
                               atol=1e-6)
    nf = gains.shape[1]
    back = ours.detokenize_flat(flat, (nf, 2 * WINDOW), gains=gains).numpy()
    jback = ref.detokenize_flat(jflat, (nf, 2 * WINDOW), gains=jgains)
    np.testing.assert_allclose(back, np.asarray(jback), rtol=1e-4, atol=1e-3)


def test_decode_is_reproducible_from_a_generator(f32_codecs):
    _, codec = f32_codecs
    latents, gains = codec.encode_with_gains(_audio(batch=1, seed=5))
    a = codec.decode(latents, generator=torch.Generator().manual_seed(7),
                     gains=gains)
    b = codec.decode(latents, generator=torch.Generator().manual_seed(7),
                     gains=gains)
    c = codec.decode(latents, generator=torch.Generator().manual_seed(8),
                     gains=gains)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    rt = codec.roundtrip(_audio(batch=1, seed=5),
                         generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(rt, a, rtol=0, atol=0)


def test_gains_are_ones_without_gain_norm():
    _, codec = _codecs("float32", gain_norm=0.0)
    latents, gains = codec.encode_with_gains(_audio(batch=1, seed=6))
    assert latents.shape[-1] == 8
    torch.testing.assert_close(gains, torch.ones_like(gains))


def test_codec_requires_frames_layout_and_a_present_device(f32_codecs):
    _, codec = f32_codecs
    features = config_from_dict(dict(_jax_config("float32").to_dict(),
                                     dataset={"dataset": "mnist"}))
    assert resolve_flatten_mode(features) == "features"
    with pytest.raises(ValueError, match="per-frame"):
        AudioCodec(codec.model, None, features, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            AudioCodec(codec.model, None, codec.config)
