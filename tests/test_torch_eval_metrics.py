"""PyTorch port: the image and audio metrics (``evaluators/metrics.py``,
``evaluators/audio_metrics.py``) against the JAX package's on the same
seeded numpy inputs.

Tolerances: rtol 1e-6 where the port's code is the JAX package's numpy
code (FID, KID, PSNR, SSIM, the log-mel spectrogram, SI-SNR, STOI, eSTOI,
NSIM, BSD); rtol 1e-4 for ``spectral_distance`` in the MDCT domain, whose
transform is the port's plain PyTorch MDCT against JAX's plain XLA one
(both the direct product at W 512 and 1024, float32 sums in another
order). STOI is also held to the independent oracle of tests/stoi_oracle.py
(abs 0.02, as tests/test_evaluators.py holds JAX's).
"""

import numpy as np
import pytest

from meanflow_audio_codec_tpu.evaluators import audio_metrics as jam
from meanflow_audio_codec_tpu.evaluators import metrics as jim
from meanflow_audio_codec_torch.evaluators import audio_metrics as am
from meanflow_audio_codec_torch.evaluators import metrics as im

EXACT = dict(rtol=1e-6, atol=0)
RATE = 44100


def _features(seed, n=60, d=6, shift=0.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) + shift


def _images(seed, n=4, noise=0.1, lo=-1.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 1.0, (n, 28, 28))
    return a, a + rng.normal(0, noise, a.shape)


def _speechlike(seed, seconds=1.5, noise=0.2):
    """Broadband 1/f noise under a syllabic 4 Hz envelope, and a degraded
    copy: every band of STOI and NSIM carries energy."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    t = np.arange(n) / RATE
    spectrum = np.fft.rfft(rng.standard_normal(n))
    spectrum /= np.sqrt(np.maximum(np.fft.rfftfreq(n, 1 / RATE), 50.0))
    clean = np.fft.irfft(spectrum, n)
    clean = clean / clean.std() * (0.55 + 0.45 * np.sin(2 * np.pi * 4 * t))
    clean = (0.3 * clean).astype(np.float32)
    test = clean + noise * clean.std() * rng.standard_normal(n)
    return clean, test.astype(np.float32)


# ---- image metrics ------------------------------------------------------------


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_frechet_distance_matches_jax(shift):
    a, b = _features(0), _features(1, shift=shift)
    np.testing.assert_allclose(im.frechet_distance(a, b),
                               jim.frechet_distance(a, b), **EXACT)
    assert im.fid is im.frechet_distance


@pytest.mark.parametrize("subsets,size", [(4, 50), (10, 100), (3, 2)])
def test_kid_matches_jax(subsets, size):
    a, b = _features(2, n=70), _features(3, n=70) * 2.0
    kwargs = dict(num_subsets=subsets, subset_size=size, seed=5)
    np.testing.assert_allclose(im.kernel_inception_distance(a, b, **kwargs),
                               jim.kernel_inception_distance(a, b, **kwargs),
                               **EXACT)
    assert im.kid is im.kernel_inception_distance


def test_kid_refuses_one_sample_as_jax():
    a = _features(4, n=1)
    for module in (im, jim):
        with pytest.raises(ValueError):
            module.kernel_inception_distance(a, a)


@pytest.mark.parametrize("lo,data_range", [(-1.0, None), (0.0, None),
                                           (0.0, 1.0), (-1.0, 4.0)])
def test_psnr_and_ssim_match_jax(lo, data_range):
    ref, test = _images(5, lo=lo)
    for fn in ("psnr", "ssim", "batch_psnr", "batch_ssim"):
        pair = (ref, test) if fn.startswith("batch") else (ref[0], test[0])
        got = getattr(im, fn)(*pair, data_range=data_range)
        want = getattr(jim, fn)(*pair, data_range=data_range)
        np.testing.assert_allclose(got, want, err_msg=fn, **EXACT)


def test_psnr_identity_and_ssim_shape_check_as_jax():
    img = _images(6)[0][0]
    assert im.psnr(img, img) == jim.psnr(img, img) == float("inf")
    np.testing.assert_allclose(im.ssim(img * 255, img * 255 + 1),
                               jim.ssim(img * 255, img * 255 + 1), **EXACT)
    with pytest.raises(ValueError):
        im.ssim(img, img[:14])


def test_ssim_of_colour_images_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (20, 20, 3))
    b = a + rng.normal(0, 0.05, a.shape)
    np.testing.assert_allclose(im.ssim(a, b), jim.ssim(a, b), **EXACT)


# ---- audio metrics ------------------------------------------------------------


@pytest.mark.parametrize("window", [512, 1024])
def test_spectral_distance_in_the_mdct_domain_matches_jax(window):
    ref, test = _speechlike(8, seconds=0.5)
    got = am.spectral_distance(ref, test, window_size=window)
    want = jam.spectral_distance(ref, test, window_size=window)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert am.spectral_distance(ref, ref, window_size=window) == 0.0


def test_spectral_distance_on_log_mel_matches_jax():
    ref, test = _speechlike(9, seconds=0.5)
    np.testing.assert_allclose(
        am.spectral_distance(ref, test, domain="logmel"),
        jam.spectral_distance(ref, test, domain="logmel"), **EXACT)
    with pytest.raises(ValueError):
        am.spectral_distance(ref, test, domain="wavelet")


@pytest.mark.parametrize("bands,fft,rate", [(64, 1024, 44100),
                                            (40, 512, 16000)])
def test_mel_filterbank_and_log_mel_match_jax(bands, fft, rate):
    np.testing.assert_array_equal(am.mel_filterbank(bands, fft, rate),
                                  jam.mel_filterbank(bands, fft, rate))
    audio = _speechlike(10, seconds=0.3)[0]
    kwargs = dict(sample_rate=rate, fft_size=fft, num_bands=bands)
    np.testing.assert_allclose(am.log_mel_spectrogram(audio, **kwargs),
                               jam.log_mel_spectrogram(audio, **kwargs),
                               **EXACT)


@pytest.mark.parametrize("noise", [0.0, 0.1, 1.0])
def test_si_snr_matches_jax(noise):
    ref, test = _speechlike(11, seconds=0.3, noise=noise)
    np.testing.assert_allclose(am.si_snr(ref, 0.5 * test),
                               jam.si_snr(ref, 0.5 * test), **EXACT)


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("noise", [0.0, 0.3, 3.0])
def test_stoi_matches_jax(extended, noise):
    ref, test = _speechlike(12, noise=noise)
    np.testing.assert_allclose(am.stoi(ref, test, extended=extended),
                               jam.stoi(ref, test, extended=extended),
                               **EXACT)


def test_stoi_refuses_short_signals_as_jax():
    ref = _speechlike(13, seconds=0.02)[0]
    for module in (am, jam):
        with pytest.raises(ValueError):
            module.stoi(ref, ref)


def test_stoi_matches_the_independent_oracle():
    """JAX's oracle case (tests/test_evaluators.py): the port's STOI and
    eSTOI within 0.02 of tests/stoi_oracle.py over the quality range, in
    its order."""
    from stoi_oracle import stoi_oracle

    rng = np.random.default_rng(7)
    t = np.arange(2 * RATE) / RATE
    spectrum = np.fft.rfft(rng.standard_normal(len(t)))
    freqs = np.fft.rfftfreq(len(t), 1 / RATE)
    spectrum *= 1.0 / np.sqrt(np.maximum(freqs, 50.0))
    clean = np.fft.irfft(spectrum, len(t))
    clean = clean / clean.std() * (0.55 + 0.45 * np.sin(2 * np.pi * 4 * t))
    conditions = {
        "clean": clean,
        "snr10": clean + 10 ** (-10 / 20) * clean.std()
        * rng.standard_normal(clean.shape),
        "snr0": clean + clean.std() * rng.standard_normal(clean.shape),
        "lowpassed": np.convolve(clean, np.ones(32) / 32, mode="same"),
    }
    ours, oracle = {}, {}
    for name, deg in conditions.items():
        ours[name] = am.stoi(clean, deg)
        oracle[name] = stoi_oracle(clean, deg, RATE)
        assert ours[name] == pytest.approx(oracle[name], abs=0.02), name
        assert am.stoi(clean, deg, extended=True) == pytest.approx(
            stoi_oracle(clean, deg, RATE, extended=True), abs=0.02), name
    assert sorted(ours, key=ours.get) == sorted(oracle, key=oracle.get)


@pytest.mark.parametrize("d", [0.0, 0.5, 0.9, 1.0])
def test_stoi_to_intelligibility_matches_jax(d):
    assert am.stoi_to_intelligibility(d) == jam.stoi_to_intelligibility(d)


@pytest.mark.parametrize("noise", [0.0, 0.2, 2.0])
def test_nsim_matches_jax(noise):
    ref, test = _speechlike(14, seconds=0.5, noise=noise)
    np.testing.assert_allclose(am.nsim(ref, test), jam.nsim(ref, test),
                               **EXACT)


@pytest.mark.parametrize("noise", [0.05, 0.5])
def test_bsd_matches_jax(noise):
    ref, test = _speechlike(15, seconds=0.5, noise=noise)
    np.testing.assert_allclose(am.bsd(ref, 0.7 * test),
                               jam.bsd(ref, 0.7 * test), **EXACT)


def test_bsd_identity_is_zero_and_silence_refused():
    ref = _speechlike(16, seconds=0.5)[0]
    assert am.bsd(ref, ref) == 0.0 == jam.bsd(ref, ref)
    with pytest.raises(ValueError):
        am.bsd(np.zeros(RATE // 2), ref)


def test_pesq_is_gated_on_the_optional_package():
    ref = _speechlike(17, seconds=0.5)[0]
    try:
        import pesq  # noqa: F401
    except ImportError:
        for module in (am, jam):
            with pytest.raises(ImportError):
                module.pesq_score(ref, ref)
    else:
        np.testing.assert_allclose(am.pesq_score(ref, ref),
                                   jam.pesq_score(ref, ref), **EXACT)
