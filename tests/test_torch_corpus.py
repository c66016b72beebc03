"""PyTorch port: disk corpora against the JAX package — the decoders, the
FLAC writer, ``make_corpus``, the pipeline stages and the native loader.

Every comparison is bit for bit: decoded audio (``load_audio_file`` of both
packages on the same files), the FLAC bytes of both writers, the files
``make_corpus`` writes, the Python stages' frames and batches, and the
native loader's batches with one producer thread once its reservoir holds
every frame (its draws are then a function of the seed alone). With two
threads, which thread frames which file is a race, so one pass is held to
the corpus's samples as a multiset. Files are written here from seeded
numpy generators; MP3 decoding runs when pygame imports, as in
tests/test_mp3.py.
"""

import importlib.util
import shutil
import struct
import time
import wave
from pathlib import Path

import numpy as np
import pytest

from meanflow_audio_codec_tpu.data import audio as jax_audio
from meanflow_audio_codec_tpu.data import flac_write as jax_flac
from meanflow_audio_codec_tpu.data import native as jax_native
from meanflow_audio_codec_tpu.tools import make_corpus as jax_make_corpus
from meanflow_audio_codec_torch.data import audio as port_audio
from meanflow_audio_codec_torch.data import flac_write as port_flac
from meanflow_audio_codec_torch.data import native as port_native
from meanflow_audio_codec_torch.ops import _build
from meanflow_audio_codec_torch.tools import make_corpus as port_make_corpus

RATE = 44100


def _write_wav(path, samples, rate=RATE, width=2):
    """(T, C) floats in [-1, 1) as a PCM WAV of ``width`` bytes a sample."""
    samples = np.asarray(samples, dtype=np.float64)
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


def _extended80(value: float) -> bytes:
    """An IEEE 754 80-bit extended float (AIFF COMM's sample rate)."""
    import math

    m, e = math.frexp(value)  # value = m * 2**e, 0.5 <= m < 1
    return (e + 16382).to_bytes(2, "big") + int(m * (1 << 64)).to_bytes(
        8, "big")


def _write_aiff(path, samples, rate=RATE, bits=16, sowt=False):
    """(T, C) floats as AIFF, or AIFC 'sowt' (little-endian samples);
    returns the (T, C) integers written."""
    samples = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    frames, channels = samples.shape
    ints = (samples * float((1 << (bits - 1)) - 1)).astype(np.int64)
    if bits == 8:
        data = ints.astype(np.int8).tobytes()
    elif bits == 16:
        data = ints.astype("<i2" if sowt else ">i2").tobytes()
    else:
        v = ints.reshape(-1)
        raw = np.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF], axis=1)
        if sowt:
            raw = raw[:, ::-1]
        data = raw.astype(np.uint8).tobytes()
    comm = struct.pack(">hIh", channels, frames, bits) + _extended80(rate)
    form = b"AIFF"
    chunks = b""
    if sowt:
        form = b"AIFC"
        comm += b"sowt" + b"\x00\x00"  # compression type, empty name
        chunks += b"FVER" + struct.pack(">II", 4, 0xA2805140)
    for cid, body in ((b"COMM", comm), (b"SSND", struct.pack(">II", 0, 0)
                                        + data)):
        chunks += cid + struct.pack(">I", len(body)) + body
        if len(body) & 1:
            chunks += b"\x00"
    Path(path).write_bytes(b"FORM" + struct.pack(">I", 4 + len(chunks))
                           + form + chunks)
    return ints


def _same_decode(path):
    """Both packages' ``load_audio_file`` of ``path``, required equal."""
    got = port_audio.load_audio_file(path)
    ref = jax_audio.load_audio_file(path)
    assert (got is None) == (ref is None)
    if got is not None:
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    return got


def _walk(rng, channels, n, lim=12000):
    steps = rng.integers(-500, 501, size=(channels, n))
    return np.clip(np.cumsum(steps, axis=1), -lim, lim).astype(np.int64)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,channels", [(1, 2), (2, 2), (2, 1), (4, 2)])
def test_wav_decodes_as_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    path = tmp_path / "a.wav"
    _write_wav(path, rng.uniform(-0.9, 0.9, (2500, channels)), width=width)
    assert _same_decode(path).shape == (2, 2500)


@pytest.mark.parametrize("bits,sowt,suffix", [
    (16, False, ".aiff"), (8, False, ".aif"), (24, False, ".aiff"),
    (16, True, ".aiff"), (24, True, ".aif")],
    ids=["aiff16", "aiff8", "aiff24", "aifc_sowt16", "aifc_sowt24"])
def test_aiff_decodes_as_jax(tmp_path, bits, sowt, suffix):
    rng = np.random.default_rng(bits + sowt)
    samples = rng.uniform(-0.8, 0.8, (1999, 2))
    path = tmp_path / f"a{suffix}"
    ints = _write_aiff(path, samples, bits=bits, sowt=sowt)
    got = _same_decode(path)
    if sowt and bits != 16:  # 'sowt' is defined for 16-bit PCM only
        assert got is None
        return
    assert got.shape == (2, 1999)
    np.testing.assert_array_equal(
        np.round(got.T * (1 << (bits - 1))).astype(np.int64), ints)


FLAC_CASES = {
    "constant": (lambda r: np.full((1, 512), -321), dict(mode="constant")),
    "verbatim": (lambda r: r.integers(-32768, 32768, size=(1, 777)),
                 dict(mode="verbatim")),
    **{f"fixed{o}": (lambda r: _walk(r, 1, 600), dict(mode=f"fixed{o}"))
       for o in range(5)},
    "lpc": (lambda r: _walk(r, 1, 1024), dict(mode="lpc",
                                              lpc=([3, -1], 1, 4))),
    "lpc_high_order_precision": (
        lambda r: _walk(r, 1, 2048),
        dict(mode="lpc", lpc=([1205, -310, 44, 12, -9, 3, 1, -2], 10, 12))),
    "rice_partitions": (lambda r: _walk(r, 1, 1024),
                        dict(mode="fixed2", partition_order=3)),
    "rice_escape": (lambda r: _walk(r, 1, 256),
                    dict(mode="fixed1", escape=True, partition_order=2)),
    "wasted_bits": (lambda r: _walk(r, 1, 512, lim=4000) << 3,
                    dict(mode="fixed1", wasted=3)),
    **{f"stereo_{s}": (lambda r: _walk(r, 2, 800),
                       dict(mode="fixed2", stereo=s))
       for s in ("independent", "left_side", "right_side", "mid_side")},
    "bits8": (lambda r: r.integers(-128, 128, size=(2, 400)),
              dict(mode="fixed1", bits=8)),
    "bits24": (lambda r: r.integers(-(1 << 23), 1 << 23, size=(1, 400)),
               dict(mode="verbatim", bits=24)),
    "partial_tail_frame": (lambda r: _walk(r, 2, 3000),
                           dict(mode="fixed1", blocksize=1024,
                                stereo="mid_side")),
}


@pytest.mark.parametrize("case", list(FLAC_CASES))
def test_flac_writes_and_decodes_as_jax(tmp_path, case):
    """The port's writer gives the JAX writer's bytes, and both packages'
    loaders decode them to the same floats: the integers written."""
    make, kwargs = FLAC_CASES[case]
    pcm = make(np.random.default_rng(len(case))).astype(np.int64)
    bits = kwargs.get("bits", 16)
    port_flac.write_flac(tmp_path / "p.flac", pcm, **kwargs)
    jax_flac.write_flac(tmp_path / "j.flac", pcm, **kwargs)
    assert ((tmp_path / "p.flac").read_bytes()
            == (tmp_path / "j.flac").read_bytes())
    got = _same_decode(tmp_path / "p.flac")
    ints = np.round(got * (1 << (bits - 1))).astype(np.int64)
    np.testing.assert_array_equal(
        ints, np.broadcast_to(pcm, (2,) + pcm.shape[1:]))


@pytest.mark.parametrize("damage", ["crc16", "truncated"])
def test_damaged_flac_gives_none_as_in_jax(tmp_path, damage):
    pcm = _walk(np.random.default_rng(10), 1, 512)
    path = tmp_path / "bad.flac"
    port_flac.write_flac(path, pcm, mode="fixed1",
                         corrupt_crc16=damage == "crc16")
    if damage == "truncated":
        path.write_bytes(path.read_bytes()[:-7])
    assert port_native.decode_audio_native(path) is None
    assert _same_decode(path) is None


def _mp3_frame(version_bits, bitrate_idx, rate_idx, mode_bits, length):
    """One syntactically valid Layer III frame with a zero payload."""
    b1 = 0xE0 | (version_bits << 3) | (1 << 1) | 1
    return (bytes([0xFF, b1, (bitrate_idx << 4) | (rate_idx << 2),
                   mode_bits << 6]) + b"\x00" * (length - 4))


FRAME_44100 = _mp3_frame(3, 9, 0, 0, 417)  # MPEG-1, 128 kbps, stereo
FRAME_48000_MONO = _mp3_frame(3, 9, 1, 3, 384)
_ID3 = b"ID3\x03\x00\x00" + bytes([0, 0, 1, 0]) + b"\xff\xfb" * 64
MP3_HEADERS = {
    "two_frames": (FRAME_44100 * 3, (44100, 2)),
    "mono_48k": (FRAME_48000_MONO * 2, (48000, 1)),
    "id3v2_skipped": (_ID3 + FRAME_44100 * 2, (44100, 2)),
    # a sync word whose computed length lands on garbage, then real frames
    "false_sync": (b"\x00" * 7 + b"\xff\xfb\x90\x00" + b"\x00" * 30
                   + FRAME_48000_MONO * 2, (48000, 1)),
    "garbage": (b"\x00\x01\x02\x03" * 100, None),
}


@pytest.mark.parametrize("case", list(MP3_HEADERS))
def test_mp3_stream_info_as_jax(tmp_path, case):
    data, want = MP3_HEADERS[case]
    path = tmp_path / "x.mp3"
    path.write_bytes(data)
    assert port_audio.mp3_stream_info(path) == want
    assert jax_audio.mp3_stream_info(path) == want


@pytest.fixture
def real_mp3():
    """pygame's own MP3 example asset, where pygame's mixer imports."""
    try:
        spec = importlib.util.find_spec("pygame")
    except ValueError:
        spec = None
    if spec is None or spec.origin is None:
        pytest.skip("pygame is not installed")
    path = Path(spec.origin).parent / "examples" / "data" / "house_lo.mp3"
    if not path.exists():
        pytest.skip("pygame's example MP3 is absent")
    try:
        import pygame.mixer  # noqa: F401
    except Exception as exc:
        pytest.skip(f"pygame.mixer does not import: {exc}")
    return path


def test_real_mp3_decodes_as_jax(real_mp3, tmp_path):
    got = port_audio._decode_mp3(real_mp3)
    ref = jax_audio._decode_mp3(real_mp3)
    assert got[1] == ref[1] == 11025
    np.testing.assert_array_equal(got[0], ref[0])
    assert float(np.sqrt(np.mean(got[0] ** 2))) > 0.05
    shutil.copy(real_mp3, tmp_path / "clip.mp3")
    with pytest.warns(UserWarning, match="sample rate"):
        assert _same_decode(tmp_path / "clip.mp3") is None
    stereo = port_audio.load_audio_file(tmp_path / "clip.mp3", resample=True)
    np.testing.assert_array_equal(
        stereo, jax_audio.load_audio_file(tmp_path / "clip.mp3",
                                          resample=True))
    assert stereo.shape[0] == 2 and abs(stereo.shape[1] / RATE - 7.26) < 0.1


def test_unknown_type_gives_none(tmp_path):
    (tmp_path / "a.ogg").write_bytes(b"OggS" + bytes(100))
    assert _same_decode(tmp_path / "a.ogg") is None


# ---------------------------------------------------------------------------
# the FLAC writer and make_corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5000, 2), (3000, 1), (2000,)])
def test_write_flac_pcm16_bytes_and_decode(tmp_path, shape):
    audio = np.random.default_rng(len(shape)).uniform(-1.1, 1.1, shape)
    audio = audio.astype(np.float32)
    port_flac.write_flac_pcm16(tmp_path / "p.flac", audio)
    jax_flac.write_flac_pcm16(tmp_path / "j.flac", audio)
    assert ((tmp_path / "p.flac").read_bytes()
            == (tmp_path / "j.flac").read_bytes())
    decoded, rate = port_native.decode_audio_native(tmp_path / "p.flac")
    assert rate == RATE
    pcm = (np.clip(audio, -1, 1) * 32767.0).astype(np.int64)
    np.testing.assert_array_equal(
        np.round(decoded * 32768).astype(np.int64),
        pcm.reshape(pcm.shape[0], -1).T)


@pytest.mark.parametrize("fmt,family", [("wav", "tonal"), ("flac", "mixed")])
def test_make_corpus_writes_jax_files(tmp_path, fmt, family):
    kwargs = dict(family=family, num_clips=3, seconds=0.2, fmt=fmt, seed=4)
    ours = port_make_corpus.make_corpus(tmp_path / "port", **kwargs)
    ref = jax_make_corpus.make_corpus(tmp_path / "jax", **kwargs)
    assert [p.name for p in ours] == [p.name for p in ref] == [
        f"{family}_{i:05d}.{fmt}" for i in range(3)]
    for a, b in zip(ours, ref):
        assert a.read_bytes() == b.read_bytes()
    assert port_make_corpus.main(
        ["--out-dir", str(tmp_path / "cli"), "--family", family,
         "--num-clips", "3", "--seconds", "0.2", "--format", fmt,
         "--seed", "4"]) == 0
    for a in ours:
        assert (tmp_path / "cli" / a.name).read_bytes() == a.read_bytes()


# ---------------------------------------------------------------------------
# the Python stages
# ---------------------------------------------------------------------------

@pytest.fixture
def corpus(tmp_path):
    """3 WAV, 2 FLAC and 1 AIFF clip of 0.1-0.3 s at 44.1 kHz, one in a
    subdirectory, plus files of other types."""
    rng = np.random.default_rng(0)
    root = tmp_path / "corpus"
    (root / "sub").mkdir(parents=True)
    for i in range(3):
        _write_wav(root / f"w{i}.wav",
                   rng.uniform(-0.5, 0.5, (int(RATE * (0.1 + 0.1 * i)), 2)))
    for i in range(2):
        port_flac.write_flac_pcm16(
            root / "sub" / f"f{i}.flac",
            rng.uniform(-0.5, 0.5, (int(RATE * (0.15 + 0.1 * i)), 2)))
    _write_aiff(root / "a0.aiff", rng.uniform(-0.5, 0.5, (6000, 2)))
    (root / "notes.txt").write_text("not audio")
    return root


def test_glob_order_is_jax(corpus):
    (corpus / "x.mp3").write_bytes(b"\x00")
    for seed in (0, 1, 7):
        got = port_audio.glob_audio_files(corpus, seed)
        assert got == jax_audio.glob_audio_files(corpus, seed)
        assert len(got) == 7


def test_framing_shuffle_and_batch_are_jax():
    rng = np.random.default_rng(1)
    streams = [rng.standard_normal((2, n)).astype(np.float32)
               for n in (100, 4096, 9000, 1)]
    frames = list(port_audio.audio_to_frames(iter(streams), 1024, seed=3))
    ref = list(jax_audio.audio_to_frames(iter(streams), 1024, seed=3))
    assert len(frames) == len(ref) > len(streams)
    for a, b in zip(frames, ref):
        assert a.shape == (1024, 2)
        np.testing.assert_array_equal(a, b)
    for size in (1, 4, 100):
        got = list(port_audio.buffer_shuffle(iter(frames), size, seed=5))
        want = list(jax_audio.buffer_shuffle(iter(frames), size, seed=5))
        assert len(got) == len(frames)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = list(port_audio.batch(iter(frames), 3))
    want = list(jax_audio.batch(iter(frames), 3))
    assert len(got) == len(frames) // 3
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("prefetch", [0, 2], ids=["sync", "threaded"])
def test_load_audio_files_is_jax(corpus, prefetch):
    (corpus / "broken.wav").write_bytes(b"RIFF\x00\x00")
    files = port_audio.glob_audio_files(corpus, 2)
    with pytest.warns(UserWarning, match="Failed to decode"):
        got = list(port_audio.load_audio_files(files, prefetch=prefetch,
                                               loop=False))
        want = list(jax_audio.load_audio_files(files, prefetch=prefetch,
                                               loop=False))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_python_pipeline_batches_are_jax(corpus):
    kwargs = dict(seed=3, frame_size=2048, batch_size=4, buffer_size=8,
                  native=False)
    ours = port_audio.build_audio_pipeline(corpus, **kwargs)
    ref = jax_audio.build_audio_pipeline(corpus, **kwargs)
    for _ in range(8):  # past one pass of the corpus (loop=True)
        a, b = next(ours), next(ref)
        assert a.shape == (4, 2048, 2) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    ours.close()
    ref.close()


def test_resampled_pipeline_is_jax(tmp_path):
    rng = np.random.default_rng(6)
    for i, rate in enumerate((48000, 22050, 48000)):
        _write_wav(tmp_path / f"r{i}.wav",
                   rng.uniform(-0.5, 0.5, (rate // 5, 2)), rate=rate)
    kwargs = dict(seed=1, frame_size=4096, batch_size=2, buffer_size=4,
                  resample=True, loop=False)
    got = list(port_audio.build_audio_pipeline(tmp_path, **kwargs))
    want = list(jax_audio.build_audio_pipeline(tmp_path, **kwargs))
    assert len(got) == len(want) >= 2
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("prefetch", [0, 2], ids=["sync", "threaded"])
def test_no_decodable_file_raises_as_jax(tmp_path, prefetch):
    _write_wav(tmp_path / "slow.wav", np.zeros((100, 2)), rate=22050)
    (tmp_path / "junk.flac").write_bytes(b"fLaC" + bytes(10))
    files = sorted(tmp_path.iterdir())
    for module in (port_audio, jax_audio):
        stream = module.load_audio_files(files, prefetch=prefetch)
        with pytest.warns(UserWarning, match="sample rate"):
            with pytest.raises(RuntimeError, match="None of the 2 audio"):
                next(stream)


# ---------------------------------------------------------------------------
# the native loader
# ---------------------------------------------------------------------------

def _filled(loader, frames):
    """Wait (10 s at most) until ``loader`` has framed ``frames`` frames."""
    deadline = time.monotonic() + 10.0
    while loader.frames_produced < frames and time.monotonic() < deadline:
        time.sleep(0.005)
    assert loader.frames_produced == frames
    return loader


def test_single_thread_loader_batches_are_jax(tmp_path):
    """Clips of 2 * 3000 + 1 samples frame to exactly 3 frames whatever the
    offset, so the reservoir's fill is known and waited for."""
    rng = np.random.default_rng(2)
    length = 2 * 3000 + 1
    _write_wav(tmp_path / "a.wav", rng.uniform(-0.5, 0.5, (length, 2)))
    _write_wav(tmp_path / "b.wav", rng.uniform(-0.5, 0.5, (length, 1)))
    port_flac.write_flac_pcm16(tmp_path / "c.flac",
                               rng.uniform(-0.5, 0.5, (length, 2)))
    _write_aiff(tmp_path / "d.aiff", rng.uniform(-0.5, 0.5, (length, 2)))
    files = sorted(tmp_path.iterdir())
    kwargs = dict(frame_size=3000, channels=2, batch_size=3,
                  buffer_frames=16, n_threads=1, seed=11, loop=False)
    ours = _filled(port_native.NativeAudioLoader(files, **kwargs), 12)
    ref = _filled(jax_native.NativeAudioLoader(files, **kwargs), 12)
    try:
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 4
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        assert ours.files_skipped == ref.files_skipped == 0
    finally:
        ours.close()
        ref.close()


def _pairs(arrays):
    """Every nonzero stereo sample pair of ``arrays`` ((..., 2)), sorted."""
    flat = np.concatenate([a.reshape(-1, 2) for a in arrays])
    flat = flat[np.any(flat != 0, axis=1)]
    return flat[np.lexsort(flat.T[::-1])]


def test_two_thread_pass_delivers_every_sample(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(5):
        _write_wav(tmp_path / f"{i}.wav",
                   rng.uniform(-0.5, 0.5, (3000 + 1700 * i, 2)))
    files = sorted(tmp_path.iterdir())
    loader = port_native.NativeAudioLoader(
        files, frame_size=2048, batch_size=1, buffer_frames=8, n_threads=2,
        seed=1, loop=False)
    try:
        frames = list(loader)
        assert len(frames) == loader.frames_produced
        assert loader.files_skipped == 0
    finally:
        loader.close()
    decoded = [port_audio.load_audio_file(f).T for f in files]
    np.testing.assert_array_equal(_pairs(frames), _pairs(decoded))


def test_wrong_rate_files_are_counted(tmp_path):
    rng = np.random.default_rng(4)
    _write_wav(tmp_path / "good.wav", rng.uniform(-0.5, 0.5, (9000, 2)))
    for i, rate in enumerate((22050, 48000)):
        _write_wav(tmp_path / f"bad{i}.wav", np.zeros((1000, 2)), rate=rate)
    for module in (port_native, jax_native):
        loader = module.NativeAudioLoader(
            sorted(tmp_path.iterdir()), frame_size=4096, batch_size=1,
            n_threads=2, seed=0, loop=False)
        try:
            assert len(list(loader)) == loader.frames_produced >= 3
            assert loader.files_skipped == 2
        finally:
            loader.close()


def test_malformed_wavs_are_skipped_in_one_pass(tmp_path):
    """Truncated fmt chunks, a zero bit depth, a data chunk claiming 3 GiB
    and a bare RIFF header are rejected by the decoder and skipped by one
    pass of the loader (``loop=False``, counted once it is exhausted)."""
    def riff(body: bytes) -> bytes:
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body

    fmt = b"\x01\x00\x02\x00" + struct.pack("<II", 44100, 176400)
    cases = {
        "short_fmt.wav": riff(b"fmt " + struct.pack("<I", 12) + fmt
                              + b"data" + struct.pack("<I", 4) + bytes(4)),
        "zero_bits.wav": riff(b"fmt " + struct.pack("<I", 16)
                              + b"\x01\x00\x02\x00"
                              + struct.pack("<II", 44100, 0)
                              + b"\x04\x00\x00\x00" + b"data"
                              + struct.pack("<I", 4) + bytes(4)),
        "huge_data.wav": riff(b"fmt " + struct.pack("<I", 16) + fmt
                              + b"\x04\x00\x10\x00" + b"data"
                              + struct.pack("<I", 3 << 30) + bytes(16)),
        "truncated.wav": b"RIFF\x08\x00\x00\x00WAVE",
    }
    for name, payload in cases.items():
        (tmp_path / name).write_bytes(payload)
        assert port_native.decode_wav_native(tmp_path / name) is None, name
    _write_wav(tmp_path / "good.wav",
               np.random.default_rng(5).uniform(-0.5, 0.5, (44100, 2)))
    loader = port_native.NativeAudioLoader(
        sorted(tmp_path.iterdir()), frame_size=16384, batch_size=1,
        n_threads=2, seed=0, loop=False)
    try:
        frames = list(loader)
        assert loader.files_skipped == len(cases)
        assert len(frames) == loader.frames_produced in (3, 4)
    finally:
        loader.close()


@pytest.mark.parametrize("extra,kwargs,native", [
    ([], {}, True),
    (["x.mp3"], {}, False),
    (["x.mp3"], {"native": True}, True),
    ([], {"native": False}, False),
    ([], {"resample": True}, False),
], ids=["all_native", "with_mp3", "forced", "opted_out", "resampled"])
def test_pipeline_routes_as_jax(corpus, extra, kwargs, native):
    for name in extra:
        (corpus / name).write_bytes(b"\x00")
    ours = port_audio.build_audio_pipeline(corpus, frame_size=2048,
                                           batch_size=2, **kwargs)
    ref = jax_audio.build_audio_pipeline(corpus, frame_size=2048,
                                         batch_size=2, **kwargs)
    try:
        assert isinstance(ours, port_native.NativeAudioLoader) is native
        assert isinstance(ref, jax_native.NativeAudioLoader) is native
    finally:
        for pipeline in (ours, ref):
            pipeline.close()


def test_a_failed_loader_build_raises(tmp_path, corpus, monkeypatch):
    """The departure from the JAX package, whose ``available()`` turns
    False (and whose pipeline takes the Python stages) when the library
    does not build: the port raises with g++'s output."""
    broken = tmp_path / "dataloader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "dataloader", broken)
    monkeypatch.setattr(_build, "_libraries", {})
    port_native._loader_library.cache_clear()
    flac = next(corpus.rglob("*.flac"))
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
            port_native.available()
        assert "dataloader.cpp" in str(info.value)
        assert "error" in str(info.value)
        assert "dataloader.cpp" in port_native.load_error()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            port_audio.load_audio_file(flac)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            port_audio.build_audio_pipeline(corpus)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            next(port_audio.load_audio_files([flac], prefetch=2))
        assert not _build.library_path("dataloader").exists()
    finally:
        port_native._loader_library.cache_clear()
