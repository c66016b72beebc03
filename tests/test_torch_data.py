"""PyTorch port: the synthetic audio sources, the host batch pools, the WAV
writer and the device replay pool, against the JAX package.

Tolerance: none. Both packages run the same numpy code on seeded
``default_rng`` generators and the pools dequantize int16 with one float32
multiply, so every batch, every pool sample and every WAV byte must be
equal bit for bit.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.data import audio as jaudio
from meanflow_audio_codec_tpu.data import device_pool as jpool
from meanflow_audio_codec_torch.data import audio, device_pool

FAMILIES = ["tonal", "rich", "speech", "mixed", "mixed2"]


def _take(source, n):
    return list(itertools.islice(source, n))


@pytest.mark.parametrize("frame_size", [1000, 2048])
@pytest.mark.parametrize("family", FAMILIES)
def test_synthetic_families_are_bitwise_jax(family, frame_size):
    ours = _take(audio.synthetic_pipeline_for_family(
        family, seed=5, frame_size=frame_size, batch_size=3), 2)
    ref = _take(jaudio.synthetic_pipeline_for_family(
        family, seed=5, frame_size=frame_size, batch_size=3), 2)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == (3, frame_size, 2)
        np.testing.assert_array_equal(a, b)


def test_default_and_unknown_family():
    ours = next(audio.synthetic_pipeline_for_family(None, seed=1,
                                                    frame_size=512,
                                                    batch_size=2))
    ref = next(jaudio.synthetic_audio_pipeline(seed=1, frame_size=512,
                                               batch_size=2))
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="synthetic_family"):
        audio.synthetic_pipeline_for_family("opera")


def _stream(seed=0):
    return audio.synthetic_audio_pipeline(seed=seed, frame_size=256,
                                          batch_size=4)


def test_replay_pool_batches_is_bitwise_jax():
    ours = _take(audio.replay_pool_batches(_stream(), pool_batches=3, seed=2,
                                           refresh=False), 5)
    ref = _take(jaudio.replay_pool_batches(
        jaudio.synthetic_audio_pipeline(seed=0, frame_size=256, batch_size=4),
        pool_batches=3, seed=2, refresh=False), 5)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_prefetch_batches_keeps_order_and_surfaces_errors():
    ours = _take(audio.prefetch_batches(_stream(), depth=2), 3)
    for a, b in zip(ours, _take(_stream(), 3)):
        np.testing.assert_array_equal(a, b)

    def broken():
        yield np.zeros(2)
        raise OSError("disk gone")

    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        list(audio.prefetch_batches(broken()))


def test_write_wav_gives_jax_bytes(tmp_path):
    x = 1.2 * next(_stream(3))[0]  # past full scale: both clip
    audio.write_wav(tmp_path / "port.wav", x, sample_rate=44100)
    jaudio.write_wav(tmp_path / "jax.wav", x, sample_rate=44100)
    audio.write_wav(tmp_path / "port_mono.wav", x[:, 0])
    jaudio.write_wav(tmp_path / "jax_mono.wav", x[:, 0])
    for name in ("", "_mono"):
        assert ((tmp_path / f"port{name}.wav").read_bytes()
                == (tmp_path / f"jax{name}.wav").read_bytes())


def _pools(pool_clips, seed):
    ours = device_pool.DeviceReplayPool(_stream(), pool_clips=pool_clips,
                                        seed=seed, device="cpu")
    ref = jpool.DeviceReplayPool(
        jaudio.synthetic_audio_pipeline(seed=0, frame_size=256, batch_size=4),
        pool_clips=pool_clips, seed=seed)
    return ours, ref


@pytest.mark.parametrize("pool_clips", [3, 10])
def test_device_pool_sample_and_refresh_are_bitwise_jax(pool_clips):
    ours, ref = _pools(pool_clips, seed=4)
    try:
        assert ours.pool_size == ref.pool_size == max(8, -(-pool_clips // 4)
                                                      * 4)
        np.testing.assert_array_equal(ours.pool.numpy(), np.asarray(ref.pool))
        for k, batch in ((1, 4), (3, 2), (2, 5)):
            got, want = ours.sample(k, batch), ref.sample(k, batch)
            assert got.dtype == torch.float32
            assert tuple(got.shape) == (k, batch, 256, 2)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert ours.refresh(wait=True) and ref.refresh(wait=True)
            np.testing.assert_array_equal(ours.pool.numpy(),
                                          np.asarray(ref.pool))
    finally:
        ours.close()
        ref.close()
    assert not ours._thread.is_alive()


def test_device_pool_wire_is_jax_int16():
    x = np.linspace(-1.3, 1.3, 101, dtype=np.float32)
    np.testing.assert_array_equal(device_pool._quantize(x), jpool._quantize(x))
    wire = jpool._quantize(x)
    got = device_pool._dequantize(torch.from_numpy(wire))
    want = jnp.asarray(wire).astype(jnp.float32) * (jpool.WIRE_SCALE / 32767.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_device_pool_refresh_skips_on_an_empty_queue():
    def slow():
        yield from _take(_stream(), 2)
        yield from iter(())  # then ends

    pool = device_pool.DeviceReplayPool(slow(), pool_clips=8, seed=0,
                                        device="cpu")
    try:
        before = pool.pool.clone()
        # the source ends after the initial fill: the producer queues its
        # end marker, then refreshes find the queue empty
        assert pool.refresh(wait=True) is False
        assert pool.refresh() is False and pool.skipped_refreshes == 1
        assert torch.equal(pool.pool, before)
    finally:
        pool.close()
