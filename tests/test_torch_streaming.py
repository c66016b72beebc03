"""PyTorch port: the streaming codec (``streaming.py``) against batch
encode/decode and against the JAX package's ``StreamingCodec``, at the small
geometry of tests/test_torch_codec.py (W=64 stereo, two ConvNeXt stages,
``coeff_scale`` 4 and ``gain_norm`` on, float32), one seeded param tree
given to both packages.

The port's per-frame noise (``frame_noise``) is its own counter-based
function of (seed, batch row, absolute frame); parity with JAX feeds the
port's decoder the JAX package's ``frame_noise`` through ``noise_fn``.

Tolerances: chunked against batch encode and decode-chunking invariance at
rtol 1e-5 / atol 1e-6 (the JAX package's own streaming tolerances: the same
arithmetic on other row counts); streaming against a batch decode of the
same noise rtol 1e-4 / atol 1e-5; the port against JAX at the codec
tolerance rtol/atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.codec import AudioCodec as JaxAudioCodec
from meanflow_audio_codec_tpu.models.factories import (
    create_flow_model as jax_create_flow_model,
)
from meanflow_audio_codec_tpu.models.train_state import TrainState
from meanflow_audio_codec_tpu.streaming import (
    StreamingCodec as JaxStreamingCodec,
)
from meanflow_audio_codec_tpu.streaming import frame_noise as jax_frame_noise
from meanflow_audio_codec_tpu.training.trainer import make_optimizer
from meanflow_audio_codec_torch.codec import AudioCodec
from meanflow_audio_codec_torch.configs import config_from_dict
from meanflow_audio_codec_torch.models.factories import create_flow_model
from meanflow_audio_codec_torch.ops import latent_quant as lq
from meanflow_audio_codec_torch.streaming import (
    StreamingCodec,
    StreamingDecoder,
    StreamingEncoder,
    frame_noise,
)
from meanflow_audio_codec_torch.weights import flax_to_torch
from test_torch_codec import _jax_config

WINDOW, HOP, NOISE = 64, 32, 128
SPAN = 2 * WINDOW
FRAME_SIZE = 1024
STREAM = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, port codec) on one seeded param tree."""
    jcfg = _jax_config("float32")
    model = jax_create_flow_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, NOISE)), jnp.zeros((2, 2)),
        method="init_all"))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        shapes)
    state = TrainState.create(apply_fn=model.apply, params=params,
                              tx=make_optimizer(jcfg), ema_params=None)
    config = config_from_dict(jcfg.to_dict())
    return (JaxAudioCodec(state, model, jcfg),
            AudioCodec(create_flow_model(config), flax_to_torch(params),
                       config, device="cpu"))


@pytest.fixture(scope="module")
def codec(codecs):
    return codecs[1]


def _audio(batch=2, t=FRAME_SIZE, ch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (batch, t, ch)).astype(np.float32)


def _stream_encode(codec, audio, sizes):
    enc = StreamingEncoder(codec)
    parts, gains, pos = [], [], 0
    for s in sizes:
        parts.append(enc.push(audio[:, pos:pos + s]))
        gains.append(enc.last_gains)
        pos += s
    parts.append(enc.flush(audio[:, pos:] if pos < audio.shape[1] else None))
    gains.append(enc.last_gains)
    return (torch.cat(parts, dim=1),
            torch.cat([g for g in gains if g is not None], dim=1))


@pytest.mark.parametrize("sizes", [
    [FRAME_SIZE],                       # one push == batch
    [256, 256, 256, 256],               # hop-aligned chunks
    [SPAN],                             # single span, rest via flush
    [96, 512, 100, 31],                 # ragged, not hop-aligned, + tail
    [16] * 8,                           # every push smaller than a frame
])
def test_streaming_encode_matches_batch(codec, sizes):
    audio = _audio()
    latents, gains = codec.encode_with_gains(audio)
    got, got_gains = _stream_encode(codec, audio, sizes)
    assert got.shape == latents.shape
    torch.testing.assert_close(got, latents, **STREAM)
    torch.testing.assert_close(got_gains, gains, **STREAM)


def test_encoder_flush_resets_for_reuse(codec):
    enc = StreamingEncoder(codec)
    for seed in (1, 2):
        clip = _audio(seed=seed)
        got = torch.cat([enc.push(clip[:, :512]), enc.push(clip[:, 512:]),
                         enc.flush()], dim=1)
        torch.testing.assert_close(got, codec.encode(clip), **STREAM)
        assert enc.frames_emitted == 0


def _stream_decode(codec, latents, gains, chunks, **kwargs):
    dec = StreamingDecoder(codec, **kwargs)
    parts = [dec.push(latents[:, a:b], gains=gains[:, a:b])
             for a, b in chunks]
    return torch.cat(parts + [dec.flush()], dim=1)


def test_streaming_decode_is_chunking_invariant(codec):
    latents, gains = codec.encode_with_gains(_audio(seed=3))
    nf = latents.shape[1]
    one = _stream_decode(codec, latents, gains, [(0, nf)], seed=7)
    fours = _stream_decode(codec, latents, gains,
                           [(i, min(i + 4, nf)) for i in range(0, nf, 4)],
                           seed=7)
    ragged = _stream_decode(codec, latents, gains,
                            [(0, 1), (1, 6), (6, 7), (7, nf)], seed=7)
    torch.testing.assert_close(fours, one, **STREAM)
    torch.testing.assert_close(ragged, one, **STREAM)


def test_streaming_decode_equals_batch_decode_of_the_same_noise(codec):
    latents, gains = codec.encode_with_gains(_audio(seed=5))
    b, nf, _ = latents.shape
    noise = frame_noise(11, 0, nf, b, NOISE).reshape(b * nf, NOISE)
    batch = codec.decode(latents, gains=gains, noise=noise)
    got = _stream_decode(codec, latents, gains,
                         [(i, min(i + 3, nf)) for i in range(0, nf, 3)],
                         seed=11)
    assert got.shape == batch.shape == (b, (nf - 1) * HOP + SPAN, 2)
    torch.testing.assert_close(got, batch, rtol=1e-4, atol=1e-5)


def test_duplex_matches_jax_with_its_frame_noise(codecs):
    jcodec, codec = codecs
    key = jax.random.PRNGKey(3)
    audio = _audio(t=4 * SPAN + 3 * HOP, seed=9)
    ours = codec.streaming(noise_fn=lambda start, n, batch, dim: np.asarray(
        jax_frame_noise(key, start, n, batch, dim)))
    ref = JaxStreamingCodec(jcodec, key=key)
    for i in range(0, audio.shape[1], SPAN):
        got = ours.push(audio[:, i:i + SPAN])
        want = np.asarray(ref.push(audio[:, i:i + SPAN]))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(ours.flush().numpy(), np.asarray(ref.flush()),
                               **TOL)


def test_frame_noise_is_a_function_of_seed_row_and_frame():
    whole = frame_noise(5, 0, 40, 3, NOISE)
    assert whole.shape == (3, 40, NOISE) and whole.dtype == torch.float32
    assert torch.equal(frame_noise(5, 17, 9, 3, NOISE), whole[:, 17:26])
    assert torch.equal(frame_noise(5, 0, 40, 1, NOISE)[0], whole[0])
    assert not torch.equal(whole[0], whole[1])
    assert not torch.equal(frame_noise(6, 0, 40, 3, NOISE), whole)
    assert frame_noise(0, 3, 2, 1, 7).shape == (1, 2, 7)  # odd width
    big = frame_noise(0, 123_456, 2000, 2, 256).reshape(-1).double()
    assert abs(big.mean().item()) < 0.01
    assert abs(big.std().item() - 1.0) < 0.01
    assert abs(((big > 1.0).double().mean() - 0.158655).item()) < 0.005
    lag = torch.corrcoef(torch.stack([big[:-1], big[1:]]))[0, 1]
    assert abs(lag.item()) < 0.01


def test_duplex_latency_and_alignment(codec):
    duplex = codec.streaming(seed=1)
    assert isinstance(duplex, StreamingCodec)
    assert duplex.latency_samples == SPAN - HOP
    audio = _audio(t=4 * SPAN)
    outs = [duplex.push(audio[:, i:i + SPAN])
            for i in range(0, audio.shape[1], SPAN)]
    assert [o.shape[1] for o in outs[1:]] == [SPAN] * (len(outs) - 1)
    assert audio.shape[1] - sum(o.shape[1] for o in outs) == (
        duplex.latency_samples)
    full = torch.cat(outs + [duplex.flush()], dim=1)
    nf = (audio.shape[1] - WINDOW) // HOP + 1
    assert full.shape[1] == (nf - 1) * HOP + SPAN
    assert torch.isfinite(full).all()


def test_packets_decode_as_the_stateful_decode_of_their_latents(codec):
    audio = _audio(seed=13, t=2048)
    enc, dec = StreamingEncoder(codec), StreamingDecoder(codec, seed=4)
    parts, packets = [], []
    bounds = [0, 64] + list(range(64 + 512, 2048 + 1, 512))
    for a, b in zip(bounds[:-1], bounds[1:]):
        packets.append(enc.push_bytes(audio[:, a:b]))
        parts.append(dec.push_bytes(packets[-1]))
    # the lookahead is still filling: an empty packet, and an empty
    # emission of batch 1 (no packet has declared the batch yet)
    assert packets[0] == b"" and parts[0].shape == (1, 0, 2)
    assert all(p[:4] == b"MACB" for p in packets[1:])
    assert all(lq.describe_bitstream(p)["gain_shape"] for p in packets[1:])
    got = torch.cat(parts[1:], dim=1)
    streams = [lq.unpack_bitstream(p) for p in packets if p]
    ref = StreamingDecoder(codec, seed=4).push(
        torch.cat([lq.dequantize_latents(s) for s in streams], dim=1),
        gains=torch.cat([s.gains for s in streams], dim=1))
    torch.testing.assert_close(got, ref, **STREAM)


def test_empty_emissions_concatenate_with_data(codec):
    duplex = codec.streaming()
    audio = _audio(t=8 * HOP)
    outs = [duplex.push(audio[:, i:i + HOP]) for i in range(0, 8 * HOP, HOP)]
    assert outs[0].shape == (2, 0, 2)
    assert torch.cat(outs, dim=1).shape[::2] == (2, 2)
    assert StreamingDecoder(codec).push_bytes(b"").shape == (1, 0, 2)


def test_flush_before_push_raises(codec):
    with pytest.raises(RuntimeError, match="before any push"):
        StreamingEncoder(codec).flush()
    with pytest.raises(RuntimeError, match="before any push"):
        StreamingDecoder(codec).flush()
