"""PyTorch port: the latent quantizers, the MACB container and the rANS
coder's binding against the JAX package (``ops/latent_quant.py``,
``ops/entropy.py``), on seeded numpy latents.

Tolerances:
  * v1 (``quantize_latents``) codes and scales: bitwise (the same float32
    operations elementwise; both round half to even);
  * ECSQ (``quantize_latents_ecsq``) scales: rtol 1e-6 (a mean and a
    standard deviation summed in another order); codes: equal but where the
    two sums put a value on a rounding boundary, at most 1e-4 of them and
    none by more than 1 (measured: 0 of 262,144 on these latents);
  * container bytes, unpacked arrays and the rANS payload: bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.ops import entropy as jax_entropy
from meanflow_audio_codec_tpu.ops import latent_quant as jlq
from meanflow_audio_codec_torch.ops import _build, entropy
from meanflow_audio_codec_torch.ops import latent_quant as lq


def _latents(seed=0, b=2, nf=7, d=32, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nf, d)) * scale).astype(np.float32)


def _offset_latents(seed=0, b=2, nf=7, d=32):
    """Large static per-dim means + a small residual (the shape of the
    frontier codec's latent space)."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((d,)).astype(np.float32)
    return mu + 0.12 * rng.standard_normal((b, nf, d)).astype(np.float32)


def _gains(seed, b, nf):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(-6, 2, (b, nf, 1))).astype(np.float32)


def _port_stream(jstream) -> lq.LatentBitstream:
    """The JAX stream's arrays as a port ``LatentBitstream``."""
    def conv(x):
        return None if x is None else torch.from_numpy(np.array(x))
    return lq.LatentBitstream(conv(jstream.codes), conv(jstream.scale),
                              qbits=jstream.qbits,
                              mean_codes=conv(jstream.mean_codes),
                              mean_scale=conv(jstream.mean_scale),
                              gains=conv(jstream.gains))


def _assert_same_stream(port, jax_stream):
    assert port.bits == jax_stream.bits and port.qbits == jax_stream.qbits
    for name in ("codes", "scale", "mean_codes", "mean_scale", "gains"):
        a, b = getattr(port, name), getattr(jax_stream, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_v1_codes_and_scales_bitwise_jax(bits):
    latents = _latents(seed=bits, b=3, nf=64, d=256)
    latents[0, 0] = 0.0  # an all-zero frame: scale 1e-12 / qmax
    ref = jlq.quantize_latents(jnp.asarray(latents), bits=bits)
    got = lq.quantize_latents(torch.from_numpy(latents), bits=bits)
    assert got.bits == bits and got.mean_codes is None
    _assert_same_stream(got, ref)
    np.testing.assert_array_equal(lq.dequantize_latents(got).numpy(),
                                  np.asarray(jlq.dequantize_latents(ref)))


def test_ecsq_matches_jax_within_rounding_boundaries():
    latents = _offset_latents(seed=5, b=4, nf=256, d=256)
    ref = jlq.quantize_latents_ecsq(jnp.asarray(latents), step_frac=0.5)
    got = lq.quantize_latents_ecsq(torch.from_numpy(latents), step_frac=0.5)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(got.mean_scale.numpy(),
                               np.asarray(ref.mean_scale), rtol=1e-6)
    for name in ("codes", "mean_codes"):
        a = getattr(got, name).numpy().astype(np.int32)
        b = np.asarray(getattr(ref, name)).astype(np.int32)
        assert a.dtype == b.dtype and a.shape == b.shape
        differ = int(np.count_nonzero(a != b))
        assert differ <= 1e-4 * a.size, (name, differ)
        assert np.abs(a - b).max() <= 1, name
    assert got.codes.dtype == got.mean_codes.dtype == torch.int8


def test_ecsq_one_stream_and_error_bound():
    latents = _offset_latents(seed=8)
    got = lq.quantize_latents_ecsq(torch.from_numpy(latents[0]), 0.4)
    assert tuple(got.codes.shape) == latents.shape[1:]
    assert tuple(got.mean_codes.shape) == (1, latents.shape[2])
    recon = lq.dequantize_latents(got).numpy()
    assert np.all(np.abs(recon - latents[0]) <= got.scale.numpy() * 0.5 + 1e-6)
    ref = jlq.quantize_latents_ecsq(jnp.asarray(latents[0]), step_frac=0.4)
    np.testing.assert_allclose(recon, np.asarray(jlq.dequantize_latents(ref)),
                               rtol=1e-6, atol=1e-6)


def test_gain_quantizers_bitwise_jax():
    gains = np.concatenate([_gains(0, 2, 50),
                            np.asarray([[[0.0], [1e-9], [1.0], [1e3]]],
                                       np.float32).repeat(2, 0)], axis=1)
    codes = lq.quantize_gains(gains)
    np.testing.assert_array_equal(codes, jlq.quantize_gains(gains))
    np.testing.assert_array_equal(lq.dequantize_gains(codes),
                                  jlq.dequantize_gains(codes))
    assert codes.dtype == np.uint8
    # the grid is a fixed point: quantize(dequantize(q)) == q
    np.testing.assert_array_equal(
        lq.quantize_gains(lq.dequantize_gains(codes)), codes)


def test_invalid_bits_and_bitrate_formula():
    with pytest.raises(ValueError, match="bits"):
        lq.quantize_latents(torch.zeros(1, 2, 4), bits=12)
    fps = 44100 / 256
    assert lq.bitstream_kbps(256, fps, 8) == jlq.bitstream_kbps(256, fps, 8)
    assert lq.bitstream_kbps(256, fps, 8) == pytest.approx(
        fps * (256 * 8 + 32) / 1000.0)


def test_stream_moves_between_devices_whole():
    stream = lq.quantize_latents_ecsq(torch.from_numpy(_offset_latents()))
    stream = dataclasses.replace(stream, gains=torch.ones(2, 7, 1))
    moved = stream.to("cpu")
    assert moved.qbits == stream.qbits
    for f in dataclasses.fields(stream):
        value = getattr(moved, f.name)
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, getattr(stream, f.name))


# ---------------------------------------------------------------------------
# the MACB container, both ways
# ---------------------------------------------------------------------------

CASES = {
    "v1-8bit": (lambda z: jlq.quantize_latents(z, bits=8), False),
    "v1-8bit-gains": (lambda z: jlq.quantize_latents(z, bits=8), True),
    "v1-4bit": (lambda z: jlq.quantize_latents(z, bits=4), False),
    "v1-4bit-gains": (lambda z: jlq.quantize_latents(z, bits=4), True),
    "v1-16bit-raw": (lambda z: jlq.quantize_latents(z, bits=16), False),
    "v1-16bit-raw-gains": (lambda z: jlq.quantize_latents(z, bits=16), True),
    "v2-ecsq": (lambda z: jlq.quantize_latents_ecsq(z, step_frac=0.5), False),
    "v2-ecsq-gains": (lambda z: jlq.quantize_latents_ecsq(z, step_frac=0.5),
                      True),
}


def _jax_case(name, shape=(3, 48, 64), seed=0):
    quantize, with_gains = CASES[name]
    b, nf, d = shape
    latents = _offset_latents(seed=seed, b=b, nf=nf, d=d)
    stream = quantize(jnp.asarray(latents))
    if with_gains:
        stream = dataclasses.replace(stream, gains=jnp.asarray(
            jlq.dequantize_gains(jlq.quantize_gains(_gains(seed, b, nf)))))
    return stream


@pytest.mark.parametrize("entropy_mode", [None, False])
@pytest.mark.parametrize("name", list(CASES))
def test_container_bytes_interoperate(name, entropy_mode):
    jstream = _jax_case(name)
    stream = _port_stream(jstream)
    data = lq.pack_bitstream(stream, entropy=entropy_mode)
    assert data == jlq.pack_bitstream(jstream, entropy=entropy_mode)
    coded = entropy_mode is None and stream.bits in (4, 8)
    assert lq.describe_bitstream(data)["coding"] == ("rANS" if coded
                                                     else "raw")
    # bytes either package writes unpack in the other to equal arrays
    _assert_same_stream(lq.unpack_bitstream(data), jlq.unpack_bitstream(data))
    back = lq.unpack_bitstream(data)
    np.testing.assert_array_equal(back.codes.numpy(), np.asarray(jstream.codes))
    # v2 adds the mean in one fused multiply-add under XLA: 1 ulp apart
    np.testing.assert_allclose(lq.dequantize_latents(back).numpy(),
                               np.asarray(jlq.dequantize_latents(
                                   jlq.unpack_bitstream(data))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [4, 8])
def test_port_quantized_v1_packs_to_jax_bytes(bits):
    latents = _latents(seed=11, b=2, nf=40, d=64)
    got = lq.pack_bitstream(lq.quantize_latents(torch.from_numpy(latents),
                                                bits=bits))
    assert got == jlq.pack_bitstream(jlq.quantize_latents(
        jnp.asarray(latents), bits=bits))


def test_tiny_stream_is_stored_raw_in_auto_mode():
    """The 512-byte frequency table loses on a tiny stream: auto mode
    stores the raw codes, as the JAX package does, giving the same bytes."""
    latents = _latents(seed=5, b=1, nf=3, d=8)
    stream = lq.quantize_latents(torch.from_numpy(latents), bits=8)
    auto = lq.pack_bitstream(stream)
    assert auto == lq.pack_bitstream(stream, entropy=False)
    assert auto == jlq.pack_bitstream(jlq.quantize_latents(
        jnp.asarray(latents), bits=8))
    assert lq.describe_bitstream(auto)["coding"] == "raw"
    coded = lq.pack_bitstream(stream, entropy=True)
    assert len(coded) > len(auto)
    assert torch.equal(lq.unpack_bitstream(coded).codes, stream.codes)


def test_one_stream_gets_a_batch_of_one():
    latents = _offset_latents(seed=8)[0]
    jstream = jlq.quantize_latents_ecsq(jnp.asarray(latents), step_frac=0.5)
    data = lq.pack_bitstream(_port_stream(jstream))
    assert data == jlq.pack_bitstream(jstream)
    stream = lq.quantize_latents_ecsq(torch.from_numpy(latents), 0.5)
    back = lq.unpack_bitstream(lq.pack_bitstream(stream))
    assert tuple(back.codes.shape) == (1,) + latents.shape
    assert torch.equal(back.codes[0], stream.codes)


def test_describe_bitstream_matches_jax():
    for name in CASES:
        data = jlq.pack_bitstream(_jax_case(name, seed=3))
        assert lq.describe_bitstream(data) == jlq.describe_bitstream(data)
    h = lq.describe_bitstream(jlq.pack_bitstream(_jax_case("v2-ecsq-gains")))
    assert (h["version"], h["quantizer"], h["gain_shape"], h["batch"]) == (
        2, "ecsq+mean", True, 3)


def test_16bit_codes_refuse_the_coder():
    stream = lq.quantize_latents(torch.from_numpy(_latents()), bits=16)
    with pytest.raises(ValueError, match="8-bit"):
        lq.pack_bitstream(stream, entropy=True)


def test_garbage_and_unknown_fields_are_rejected_as_in_jax():
    good = jlq.pack_bitstream(_jax_case("v1-8bit"))
    bad_flags = good[:6] + bytes([good[6] | 0x04]) + good[7:]
    bad_version = good[:4] + bytes([3]) + good[5:]
    for data, match in ((b"nope" + b"\x00" * 64, "MACB"),
                        (bad_flags, "flags"), (bad_version, "version")):
        with pytest.raises(ValueError, match=match):
            lq.unpack_bitstream(data)
        with pytest.raises(ValueError, match=match):
            jlq.unpack_bitstream(data)
    with pytest.raises(ValueError, match="MACB"):
        lq.describe_bitstream(b"RIFF" + b"\x00" * 16)


# ---------------------------------------------------------------------------
# the rANS coder
# ---------------------------------------------------------------------------


def _laplacian_codes(n, seed=0, scale=12.0):
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.laplace(0, scale, n)),
                   -127, 127).astype(np.int8)


@pytest.mark.parametrize("n", [0, 1, 3, 256, 10_000, 300_000])
def test_rans_payload_equals_jax_and_round_trips(n):
    codes = _laplacian_codes(n)
    data = entropy.entropy_encode(codes)
    assert data == jax_entropy.entropy_encode(codes)
    np.testing.assert_array_equal(entropy.entropy_decode(data, n), codes)


def test_rans_extremes_and_malformed_streams():
    codes = np.arange(-128, 128, dtype=np.int8).repeat(7)
    data = entropy.entropy_encode(codes)
    np.testing.assert_array_equal(entropy.entropy_decode(data, codes.size),
                                  codes)
    assert len(entropy.entropy_encode(np.zeros(100_000, np.int8))) < 600
    data = bytearray(entropy.entropy_encode(_laplacian_codes(1000)))
    with pytest.raises(ValueError, match="malformed"):
        entropy.entropy_decode(bytes(data[:300]), 1000)  # truncated table
    data[10] ^= 0xFF  # the frequency table no longer sums to 4096
    with pytest.raises(ValueError, match="malformed"):
        entropy.entropy_decode(bytes(data), 1000)


def test_coder_builds_into_the_package_build_dir():
    entropy.entropy_encode(np.zeros(4, np.int8))
    path = _build.library_path("entropy")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("libentropy-") and path.suffix == ".so"
    assert _build.HOST_SOURCES["entropy"].name == "entropy.cpp"
    assert _build.HOST_SOURCES["entropy"].parent.name == "native"


def test_a_failed_coder_build_raises_instead_of_storing_raw(tmp_path,
                                                            monkeypatch):
    """The one departure from the JAX package, which stores raw codes when
    its coder does not build: the port raises with the compiler's output."""
    broken = tmp_path / "entropy.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "entropy", broken)
    monkeypatch.setattr(_build, "_libraries", {})
    entropy._coder.cache_clear()
    try:
        stream = lq.quantize_latents(torch.from_numpy(
            _latents(b=2, nf=64, d=64)), bits=8)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
            lq.pack_bitstream(stream)
        assert "entropy.cpp" in str(info.value)
        assert "error" in str(info.value)
        assert not _build.library_path("entropy").exists()
    finally:
        entropy._coder.cache_clear()
