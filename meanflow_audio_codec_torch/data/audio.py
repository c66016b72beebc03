"""Audio sources: disk corpora, synthetic families, batch pools, file input
and WAV output.

Counterpart of ``meanflow_audio_codec_tpu/data/audio.py``, copied as it is
but for the native loader's build (below):

  * the decoders: WAV through the stdlib ``wave`` module, AIFF/AIFC and FLAC
    through the native decoder of ``native/dataloader.cpp``
    (``data/native.py``), MP3 through ``minimp3py`` when it imports, else
    pygame's SDL mixer when that imports, else not at all (the file is
    skipped); ``load_audio_file`` with the polyphase ``resample_audio``;
  * the pipeline stages, ``glob(+shuffle) -> prefetch decode (a worker
    thread, a bounded blocking queue) -> random-offset framing -> buffer
    shuffle (O(1) swap-and-pop) -> batch``, and ``build_audio_pipeline``,
    which takes the native loader when every file has a native extension
    and nothing is resampled, and these Python stages otherwise;
  * the synthetic ``tonal``, ``rich``, ``speech``, ``mixed`` and ``mixed2``
    families, ``replay_pool_batches``, ``prefetch_batches`` and
    ``write_wav``: plain numpy with seeded ``default_rng`` generators, so
    the same seed gives the same batches, bit for bit, in both packages.

Batches are float32 ``[B, frame_size, 2]``. Where the JAX package takes
the Python stages because its native library did not build, the port raises
with the compiler's output.
"""

from __future__ import annotations

import os
import queue
import threading
import warnings
import wave
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

from meanflow_audio_codec_torch.data import native as native_mod

TARGET_SAMPLE_RATE = 44100
DEFAULT_FRAME_SIZE = 256 * 256 * 3  # ~4.46 s @ 44.1 kHz
AUDIO_EXTENSIONS = (".wav", ".aiff", ".aif", ".flac", ".mp3")
#: extensions the native decoder reads (it dispatches on the container's
#: magic: RIFF, FORM, fLaC)
NATIVE_EXTENSIONS = (".wav", ".aiff", ".aif", ".flac")


def synthetic_audio_pipeline(seed: int = 0,
                             frame_size: int = DEFAULT_FRAME_SIZE,
                             batch_size: int = 32,
                             sample_rate: int = TARGET_SAMPLE_RATE
                             ) -> Iterator[np.ndarray]:
    """Deterministic stereo mixtures (harmonics + AM noise) shaped exactly
    like the real pipeline output [B, frame_size, 2].

    Fully vectorised over the batch (one sin over [B, 4, T] per draw): a
    per-frame Python loop would make the source the training loop's
    bottleneck.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(frame_size, dtype=np.float32) / sample_rate  # [T]
    two_pi = np.float32(2 * np.pi)

    def sin_cycles(cycles: np.ndarray) -> np.ndarray:
        # sin(2*pi*cycles) with the argument reduced to [-pi, pi) FIRST —
        # raw arguments reach ~2*pi*4000*0.7 ~ 18k rad, and NumPy's sin is
        # ~40x slower outside [-pi, pi] (large-argument reduction path).
        # floor-based reduction: np.mod lowers to the much slower fmod.
        centered = cycles - np.floor(cycles + np.float32(0.5))
        return np.sin(two_pi * centered)

    while True:
        b = batch_size
        freqs = rng.uniform(55.0, 4000.0, size=(b, 4, 1)).astype(np.float32)
        amps = rng.dirichlet(np.ones(4), size=b).astype(np.float32)[..., None]
        phases = rng.uniform(0, 1.0, size=(b, 4, 1)).astype(np.float32)
        left = np.sum(amps * sin_cycles(freqs * t + phases),
                      axis=1)                                   # [B, T]
        pan = rng.uniform(0.2, 0.8, size=(b, 1)).astype(np.float32)
        noise = rng.standard_normal((b, frame_size),
                                    dtype=np.float32) * np.float32(0.02)
        env_hz = rng.uniform(0.2, 2.0, size=(b, 1)).astype(np.float32)
        envelope = 0.5 * (1 + sin_cycles(env_hz * t))
        left = (left * envelope + noise).astype(np.float32)
        right = (left * pan + noise * (1 - pan)).astype(np.float32)
        yield np.stack([left, right], axis=-1)


def synthetic_audio_pipeline_rich(seed: int = 0,
                                  frame_size: int = DEFAULT_FRAME_SIZE,
                                  batch_size: int = 32,
                                  sample_rate: int = TARGET_SAMPLE_RATE
                                  ) -> Iterator[np.ndarray]:
    """Synthetic corpus shaped toward real-audio statistics.

    The tonal family (:func:`synthetic_audio_pipeline`) is 4-partial
    steady-state mixtures — none of the structure that makes real music hard
    for a codec. This family adds, per clip (random subset):

      * polyphonic chords: up to 3 voices x 4 harmonics with power-law
        rolloff and per-harmonic detune;
      * pitch glides (chirps) with a formant-like resonance envelope — the
        closed-form quadratic-phase sweep keeps it vectorised;
      * percussive transients: exponentially-decaying noise+tone bursts at
        random onsets (3 events/clip);
      * broadband noise beds: white noise coloured to 1/f^alpha via one
        rFFT per batch;
      * silence/onset structure: cosine-ramp gates delaying the onset;
      * per-component constant-power stereo panning.

    Stands in for the reference's real-music corpus
    (reference datasets/audio.py:93-132) where no corpus is at hand: models
    trained on the tonal family are evaluated on THIS family to measure
    cross-family generalization (documentation/results.md).
    """
    rng = np.random.default_rng(seed)
    t = np.arange(frame_size, dtype=np.float32) / sample_rate     # [T]
    dur = frame_size / sample_rate
    two_pi = np.float32(2 * np.pi)

    def sin_cycles(cycles: np.ndarray) -> np.ndarray:
        centered = cycles - np.floor(cycles + np.float32(0.5))
        return np.sin(two_pi * centered)

    n_voices, n_harm, n_events = 3, 4, 3
    k_h = np.arange(1, n_harm + 1, dtype=np.float32)              # [H]

    while True:
        b = batch_size
        # --- polyphonic chords: [B, V, H] partials --------------------------
        f0 = np.exp(rng.uniform(np.log(55.0), np.log(1000.0),
                                size=(b, n_voices, 1))).astype(np.float32)
        detune = (1.0 + rng.normal(0.0, 0.002, size=(b, n_voices, n_harm))
                  ).astype(np.float32)
        rolloff = rng.uniform(0.5, 2.0, size=(b, 1, 1)).astype(np.float32)
        voice_amp = (rng.dirichlet(np.ones(n_voices), size=b)
                     .astype(np.float32)[..., None]
                     * (rng.random((b, n_voices, 1)) < 0.75))
        freqs = (f0 * k_h * detune).reshape(b, -1, 1)             # [B, VH, 1]
        amps = (voice_amp * k_h ** (-rolloff)).reshape(b, -1, 1)
        phases = rng.uniform(0, 1, size=(b, n_voices * n_harm, 1)
                             ).astype(np.float32)
        chord = np.sum(amps * sin_cycles(freqs * t + phases), axis=1)
        env_hz = rng.uniform(0.3, 3.0, size=(b, 1)).astype(np.float32)
        chord *= 0.5 * (1.0 + sin_cycles(env_hz * t))             # slow AM

        # --- pitch glide with formant-like resonance ------------------------
        fa = np.exp(rng.uniform(np.log(80.0), np.log(2000.0),
                                size=(b, 1))).astype(np.float32)
        fb = np.exp(rng.uniform(np.log(80.0), np.log(2000.0),
                                size=(b, 1))).astype(np.float32)
        # f(t) = fa + (fb-fa) t/dur  ->  cycles(t) = fa t + (fb-fa) t^2/(2 dur)
        inst_f = fa + (fb - fa) * (t / np.float32(dur))
        cyc = fa * t + (fb - fa) * t * t / np.float32(2 * dur)
        formant = np.exp(rng.uniform(np.log(300.0), np.log(3000.0),
                                     size=(b, 1))).astype(np.float32)
        reso = np.exp(-np.square(np.log(inst_f / formant))
                      / np.float32(2 * 0.5 ** 2)).astype(np.float32)
        glide = (reso * (sin_cycles(cyc)
                         + 0.4 * sin_cycles(2 * cyc))).astype(np.float32)
        glide *= (rng.random((b, 1)) < 0.5)

        # --- percussive transients ------------------------------------------
        t0 = rng.uniform(0.0, 0.9 * dur, size=(b, n_events, 1)
                         ).astype(np.float32)
        tau = np.exp(rng.uniform(np.log(0.003), np.log(0.08),
                                 size=(b, n_events, 1))).astype(np.float32)
        hit_on = (rng.random((b, n_events, 1)) < 0.6).astype(np.float32)
        age = t - t0                                               # [B, E, T]
        env = np.where(age >= 0, np.exp(-np.maximum(age, 0) / tau),
                       np.float32(0.0)).astype(np.float32) * hit_on
        f_hit = np.exp(rng.uniform(np.log(60.0), np.log(3000.0),
                                   size=(b, n_events, 1))).astype(np.float32)
        tone_mix = rng.uniform(0.0, 1.0, size=(b, n_events, 1)
                               ).astype(np.float32)
        burst_noise = rng.standard_normal((b, n_events, frame_size),
                                          dtype=np.float32)
        perc = np.sum(env * (tone_mix * sin_cycles(f_hit * age)
                             + (1 - tone_mix) * burst_noise), axis=1)

        # --- broadband 1/f^alpha noise bed ----------------------------------
        white = rng.standard_normal((b, frame_size), dtype=np.float32)
        spec = np.fft.rfft(white, axis=-1)
        fbin = np.arange(spec.shape[-1], dtype=np.float32)
        fbin[0] = 1.0
        alpha = rng.uniform(0.0, 1.5, size=(b, 1)).astype(np.float32)
        bed = np.fft.irfft(spec * fbin ** (-alpha / 2), n=frame_size,
                           axis=-1).astype(np.float32)
        bed /= (np.std(bed, axis=-1, keepdims=True) + 1e-6)
        bed *= np.exp(rng.uniform(np.log(0.002), np.log(0.08),
                                  size=(b, 1))).astype(np.float32)

        # --- mix, gate, stereo ----------------------------------------------
        comp = np.stack([chord, glide, perc, bed], axis=1)        # [B, K, T]
        levels = rng.dirichlet(np.ones(4) * 0.8, size=b
                               ).astype(np.float32)[..., None]
        comp *= levels
        gate_on = rng.random((b, 1)) < 0.35
        onset = rng.uniform(0.0, 0.5 * dur, size=(b, 1)).astype(np.float32)
        ramp = np.float32(0.005)
        gate = np.clip((t - onset) / ramp, 0.0, 1.0).astype(np.float32)
        gate = np.where(gate_on, 0.5 - 0.5 * np.cos(np.pi * gate),
                        np.float32(1.0)).astype(np.float32)
        pan = rng.uniform(0.1, 0.9, size=(b, 4, 1)).astype(np.float32)
        left = np.sum(comp * np.sqrt(pan), axis=1) * gate
        right = np.sum(comp * np.sqrt(1 - pan), axis=1) * gate
        out = np.stack([left, right], axis=-1)                    # [B, T, 2]
        peak = np.max(np.abs(out), axis=(1, 2), keepdims=True)
        target = rng.uniform(0.25, 0.9, size=(b, 1, 1)).astype(np.float32)
        yield (out * target / (peak + 1e-6)).astype(np.float32)


def synthetic_audio_pipeline_speech(seed: int = 0,
                                    frame_size: int = DEFAULT_FRAME_SIZE,
                                    batch_size: int = 32,
                                    sample_rate: int = TARGET_SAMPLE_RATE
                                    ) -> Iterator[np.ndarray]:
    """Speech-like synthetic family: formant-filtered glottal harmonics.

    The tonal/rich families have no speech structure, which makes
    STOI/eSTOI (designed for 10 kHz-band speech, Taal et al. 2011)
    near-degenerate on them (documentation/results.md "STOI scale
    break"). This family synthesizes pseudo-speech so the perceptual
    metrics measure what they were built for:

      * glottal source: K=40 harmonics of a drifting f0 (90-250 Hz male/
        female range) with vibrato, declination and low-rate jitter;
      * vocal tract: 3 formant resonances (log-normal bumps around
        time-varying centers F1 300-800, F2 800-2200, F3 2300-3200 Hz)
        plus a -6 dB/oct source tilt, applied as per-harmonic amplitude
        envelopes at control rate (hop 256) — no filtering pass needed;
      * prosody: syllabic energy modulation at 2.5-6 Hz with per-clip
        random pulse sharpening, pauses via a slow gate;
      * fricatives: high-band (2-7 kHz) shaped noise bursts gated in the
        syllable gaps (complementary envelope), Bernoulli per clip;
      * near-centered stereo (speech is a center-panned source).

    Stands in (with the rich family) for the reference's real corpus
    (reference datasets/audio.py:93-132) on the axis music misses.
    Amplitude envelopes are computed on a T/256 control grid and
    upsampled by repetition — the full-rate work is one [B, K, T] sin.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(frame_size, dtype=np.float32) / sample_rate      # [T]
    two_pi = np.float32(2 * np.pi)
    hop = 256
    n_ctrl = -(-frame_size // hop)  # ceil: cover a non-multiple tail
    t_ctrl = (np.arange(n_ctrl, dtype=np.float32) + 0.5) * hop / sample_rate
    n_harm = 40
    k_h = np.arange(1, n_harm + 1, dtype=np.float32)               # [K]

    def sin_cycles(cycles: np.ndarray) -> np.ndarray:
        centered = cycles - np.floor(cycles + np.float32(0.5))
        return np.sin(two_pi * centered)

    f_lo = np.array([300.0, 800.0, 2300.0], dtype=np.float32)
    f_hi = np.array([800.0, 2200.0, 3200.0], dtype=np.float32)
    band_limit = np.float32(5000.0)

    while True:
        b = batch_size
        # --- f0 contour at audio rate: base x vibrato x declination -------
        f0_base = np.exp(rng.uniform(np.log(90.0), np.log(250.0),
                                     size=(b, 1))).astype(np.float32)
        vib_hz = rng.uniform(4.0, 7.0, size=(b, 1)).astype(np.float32)
        vib_amt = rng.uniform(0.005, 0.03, size=(b, 1)).astype(np.float32)
        vib_ph = rng.uniform(0, 1, size=(b, 1)).astype(np.float32)
        decl = rng.uniform(-0.25, 0.05, size=(b, 1)).astype(np.float32)
        drift_hz = rng.uniform(0.3, 1.2, size=(b, 1)).astype(np.float32)
        drift_amt = rng.uniform(0.02, 0.12, size=(b, 1)).astype(np.float32)
        drift_ph = rng.uniform(0, 1, size=(b, 1)).astype(np.float32)
        log_f0 = (np.log(f0_base) + decl * t[None, :]
                  + vib_amt * sin_cycles(vib_hz * t + vib_ph)
                  + drift_amt * sin_cycles(drift_hz * t + drift_ph))
        f0 = np.exp(log_f0).astype(np.float32)                     # [B, T]
        phase = np.cumsum(f0, axis=-1, dtype=np.float64) / sample_rate
        phase = phase.astype(np.float32)                           # cycles

        # --- formant trajectories + harmonic amplitudes at control rate ---
        f0_ctrl = f0[:, hop // 2::hop]                             # [B, Tc']
        if f0_ctrl.shape[-1] < n_ctrl:  # ceil grid: pad with the last value
            f0_ctrl = np.pad(f0_ctrl,
                             ((0, 0), (0, n_ctrl - f0_ctrl.shape[-1])),
                             mode="edge")
        f0_ctrl = f0_ctrl[:, :n_ctrl]                              # [B, Tc]
        harm_f = k_h[None, :, None] * f0_ctrl[:, None, :]          # [B,K,Tc]
        amp = np.zeros((b, n_harm, n_ctrl), dtype=np.float32)
        for i in range(3):
            center = np.exp(rng.uniform(np.log(f_lo[i]), np.log(f_hi[i]),
                                        size=(b, 1))).astype(np.float32)
            move_hz = rng.uniform(2.0, 5.0, size=(b, 1)).astype(np.float32)
            move_amt = rng.uniform(0.08, 0.35, size=(b, 1)).astype(np.float32)
            move_ph = rng.uniform(0, 1, size=(b, 1)).astype(np.float32)
            track = center * np.exp(
                move_amt * sin_cycles(move_hz * t_ctrl + move_ph))
            bw = rng.uniform(0.12, 0.25, size=(b, 1, 1)).astype(np.float32)
            gain = np.float32([1.0, 0.63, 0.35][i])
            amp += gain * np.exp(
                -0.5 * np.square(np.log(harm_f / track[:, None, :])) / bw**2)
        tilt = (200.0 / np.maximum(harm_f, 200.0))                 # -6 dB/oct
        amp = (amp + 0.05) * tilt * (harm_f < band_limit)
        amp_full = np.repeat(amp, hop, axis=-1)[..., :frame_size]  # [B,K,T]

        # --- voiced part: sum of formant-weighted harmonics ---------------
        ph_k = rng.uniform(0, 1, size=(b, n_harm, 1)).astype(np.float32)
        voiced = np.sum(amp_full * sin_cycles(
            k_h[None, :, None] * phase[:, None, :] + ph_k), axis=1)

        # --- syllabic prosody envelope -------------------------------------
        syl_hz = rng.uniform(2.5, 6.0, size=(b, 1)).astype(np.float32)
        syl_ph = rng.uniform(0, 1, size=(b, 1)).astype(np.float32)
        sharp = rng.uniform(1.5, 4.0, size=(b, 1)).astype(np.float32)
        syl = np.float32(0.03) + np.float32(0.97) * np.power(
            0.5 * (1 + sin_cycles(syl_hz * t + syl_ph)), sharp)
        pause_hz = rng.uniform(0.5, 1.3, size=(b, 1)).astype(np.float32)
        pause_ph = rng.uniform(0, 1, size=(b, 1)).astype(np.float32)
        # floor 0.04: a short clip that lands entirely in a pause must
        # still carry signal (peak-normalize would blow up silence)
        gate = np.clip(2.5 * (0.5 + 0.5 * sin_cycles(
            pause_hz * t + pause_ph)) - 0.25, 0.04, 1.0)
        voiced *= (syl * gate).astype(np.float32)

        # --- fricative noise in the syllable gaps --------------------------
        fric_on = (rng.random((b, 1)) < 0.7).astype(np.float32)
        noise = rng.standard_normal((b, frame_size), dtype=np.float32)
        spec = np.fft.rfft(noise, axis=-1)
        fbin = (np.arange(spec.shape[-1], dtype=np.float32)
                * sample_rate / frame_size)
        f_fric = np.exp(rng.uniform(np.log(2000.0), np.log(6000.0),
                                    size=(b, 1))).astype(np.float32)
        shape = np.exp(-0.5 * np.square(np.log(
            np.maximum(fbin[None, :], 1.0) / f_fric)) / 0.36)
        fric = np.fft.irfft(spec * shape, n=frame_size, axis=-1
                            ).astype(np.float32)
        fric /= (np.std(fric, axis=-1, keepdims=True) + 1e-6)
        fric_lvl = rng.uniform(0.05, 0.25, size=(b, 1)).astype(np.float32)
        fric *= fric_on * fric_lvl * ((1.0 - syl) ** 2 * gate
                                      ).astype(np.float32)

        # --- mix, near-center stereo, peak normalize -----------------------
        mono = voiced + fric
        pan = rng.uniform(0.4, 0.6, size=(b, 1)).astype(np.float32)
        out = np.stack([mono * np.sqrt(pan), mono * np.sqrt(1 - pan)],
                       axis=-1)                                    # [B, T, 2]
        peak = np.max(np.abs(out), axis=(1, 2), keepdims=True)
        target = rng.uniform(0.3, 0.85, size=(b, 1, 1)).astype(np.float32)
        yield (out * target / (peak + 1e-6)).astype(np.float32)


def synthetic_audio_pipeline_mixed(seed: int = 0,
                                   frame_size: int = DEFAULT_FRAME_SIZE,
                                   batch_size: int = 32,
                                   sample_rate: int = TARGET_SAMPLE_RATE
                                   ) -> Iterator[np.ndarray]:
    """Per-clip interleave of the tonal, rich and speech families
    (0.35 / 0.35 / 0.30).

    The training-distribution proxy for the reference's real-music corpus
    (reference datasets/audio.py:93-132): models trained tonal-only drop
    ~10 dB SI-SNR on the rich family (documentation/results.md
    cross-family table), so the mixed stream trains all regimes in one
    run. Clips are drawn independently per row, so every batch carries
    all families and the replay pool stays balanced in expectation.

    Round-5 change: the speech family joined the mix (was 50/50
    tonal/rich through round 4 — results tagged "mixed2" predate it);
    ``mixed2`` keeps the historical two-family stream reproducible.
    """
    rng = np.random.default_rng(seed)
    tonal = synthetic_audio_pipeline(seed=seed, frame_size=frame_size,
                                     batch_size=batch_size,
                                     sample_rate=sample_rate)
    rich = synthetic_audio_pipeline_rich(seed=seed + 1,
                                         frame_size=frame_size,
                                         batch_size=batch_size,
                                         sample_rate=sample_rate)
    speech = synthetic_audio_pipeline_speech(seed=seed + 2,
                                             frame_size=frame_size,
                                             batch_size=batch_size,
                                             sample_rate=sample_rate)
    for a, b, c in zip(tonal, rich, speech):
        u = rng.random(batch_size)
        pick = np.where(u < 0.35, 0, np.where(u < 0.70, 1, 2))
        stacked = np.stack([a, b, c], axis=0)                # [3, B, T, 2]
        yield stacked[pick, np.arange(batch_size)]


def synthetic_audio_pipeline_mixed2(seed: int = 0,
                                    frame_size: int = DEFAULT_FRAME_SIZE,
                                    batch_size: int = 32,
                                    sample_rate: int = TARGET_SAMPLE_RATE
                                    ) -> Iterator[np.ndarray]:
    """The historical round-2..4 two-family (tonal/rich 50/50) mix —
    kept so pre-speech evaluation rows stay reproducible."""
    rng = np.random.default_rng(seed)
    tonal = synthetic_audio_pipeline(seed=seed, frame_size=frame_size,
                                     batch_size=batch_size,
                                     sample_rate=sample_rate)
    rich = synthetic_audio_pipeline_rich(seed=seed + 1,
                                         frame_size=frame_size,
                                         batch_size=batch_size,
                                         sample_rate=sample_rate)
    for a, b in zip(tonal, rich):
        pick_rich = rng.random(batch_size) < 0.5
        yield np.where(pick_rich[:, None, None], b, a)


SYNTHETIC_FAMILIES = {
    "tonal": synthetic_audio_pipeline,
    "rich": synthetic_audio_pipeline_rich,
    "speech": synthetic_audio_pipeline_speech,
    "mixed": synthetic_audio_pipeline_mixed,
    "mixed2": synthetic_audio_pipeline_mixed2,
}


def synthetic_pipeline_for_family(family: str | None, **kwargs
                                  ) -> Iterator[np.ndarray]:
    """Dispatch on the ``synthetic_family`` knob ('tonal' default)."""
    name = family or "tonal"
    if name not in SYNTHETIC_FAMILIES:
        raise ValueError(f"Unknown synthetic_family: {name!r}. "
                         f"Choose from {sorted(SYNTHETIC_FAMILIES)}")
    return SYNTHETIC_FAMILIES[name](**kwargs)


def replay_pool_batches(stream: Iterator[np.ndarray],
                        pool_batches: int = 64,
                        seed: int = 0,
                        refresh: bool = True) -> Iterator[np.ndarray]:
    """Sampling-with-replacement replay pool over a batch iterator.

    Synthesising (or decoding) audio on the host can be slower than the
    train step consumes it. The pool decouples the two rates: the consumer
    draws a uniformly-resampled batch from a pre-filled pool of
    ``pool_batches`` batches (rows remixed across the whole pool so
    consecutive draws decorrelate), while a daemon thread keeps overwriting
    random pool slots with fresh batches from ``stream`` as fast as the CPU
    can make them. Over a long run the
    model sees unbounded diversity; each clip is merely reused for the few
    steps it stays resident.
    """
    rng = np.random.default_rng(seed)
    pool = [np.asarray(next(stream)) for _ in range(pool_batches)]
    batch_size = pool[0].shape[0]
    stop = threading.Event()

    if refresh:
        def refresher():
            refresher_rng = np.random.default_rng(seed + 1)
            for item in stream:
                if stop.is_set():
                    return
                slot = int(refresher_rng.integers(0, pool_batches))
                pool[slot] = np.asarray(item)  # atomic slot swap under GIL

        threading.Thread(target=refresher, daemon=True).start()

    try:
        while True:
            # remix rows across the pool: batch_size independent (slot, row)
            # draws rather than one whole stored batch
            slots = rng.integers(0, pool_batches, size=batch_size)
            rows = rng.integers(0, batch_size, size=batch_size)
            yield np.stack([pool[s][r] for s, r in zip(slots, rows)])
    finally:
        stop.set()


def prefetch_batches(stream: Iterator[np.ndarray],
                     depth: int = 4) -> Iterator[np.ndarray]:
    """Run any batch iterator in a daemon producer thread with a bounded
    blocking queue, overlapping host-side batch assembly with device steps.

    Same stop-flag discipline as ``_load_audio_files_threaded``: the
    producer re-checks a stop event while blocked on a full queue, and the
    consumer drains on teardown, so abandoning the generator never leaks
    the thread.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    _SENTINEL = object()
    failure: list[BaseException] = []  # producer error, re-raised in consumer

    def worker():
        try:
            for item in stream:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:  # surface stream errors, not clean EOF
            failure.append(exc)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if failure:
                    raise RuntimeError(
                        "prefetch producer failed") from failure[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def write_wav(path: Path | str, audio: np.ndarray,
              sample_rate: int = TARGET_SAMPLE_RATE) -> None:
    """Write (T,) or (T, C) float32 [-1, 1] audio as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as wav:
        wav.setnchannels(audio.shape[1])
        wav.setsampwidth(2)
        wav.setframerate(sample_rate)
        wav.writeframes(pcm.tobytes())


def _decode_wav(path: Path) -> tuple[np.ndarray, int] | None:
    """(C, T) float32 samples and the rate of an 8-, 16- or 32-bit PCM WAV;
    None for another sample width."""
    with wave.open(str(path), "rb") as wav:
        rate = wav.getframerate()
        channels = wav.getnchannels()
        width = wav.getsampwidth()
        raw = wav.readframes(wav.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        pcm = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2**31
    elif width == 1:
        pcm = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        return None
    audio = pcm.reshape(-1, channels).T  # (C, T)
    return audio, rate


def _decode_native(path: Path) -> tuple[np.ndarray, int] | None:
    """AIFF/AIFC and FLAC through the native decoder (constant, verbatim,
    fixed and LPC subframes, Rice residuals, CRC-checked frames)."""
    return native_mod.decode_audio_native(path)


#: (MPEG version key -> sample-rate table); version bits from the frame
#: header: 3 = MPEG-1, 2 = MPEG-2, 0 = MPEG-2.5.
_MP3_RATES = {3: (44100, 48000, 32000),
              2: (22050, 24000, 16000),
              0: (11025, 12000, 8000)}
_MP3_BITRATES_V1L3 = (0, 32, 40, 48, 56, 64, 80, 96, 112,
                      128, 160, 192, 224, 256, 320)
_MP3_BITRATES_V2L3 = (0, 8, 16, 24, 32, 40, 48, 56, 64,
                      80, 96, 112, 128, 144, 160)


def _mp3_frame_at(data: bytes, i: int) -> tuple[int, int, int] | None:
    """Parse a candidate MPEG Layer III frame header at offset ``i``.

    Returns (sample_rate, channels, frame_length_bytes) or None. The frame
    length lets the caller check that a *second* sync word follows, which
    rejects false syncs inside the payload.
    """
    if i + 4 > len(data) or data[i] != 0xFF or (data[i + 1] & 0xE0) != 0xE0:
        return None
    b1, b2, b3 = data[i + 1], data[i + 2], data[i + 3]
    version = (b1 >> 3) & 3
    layer = (b1 >> 1) & 3
    if version not in _MP3_RATES or layer != 1:  # layer bits 01 = Layer III
        return None
    bitrate_idx = (b2 >> 4) & 0xF
    rate_idx = (b2 >> 2) & 3
    if bitrate_idx in (0, 0xF) or rate_idx == 3:
        return None
    rate = _MP3_RATES[version][rate_idx]
    kbps = (_MP3_BITRATES_V1L3 if version == 3
            else _MP3_BITRATES_V2L3)[bitrate_idx]
    padding = (b2 >> 1) & 1
    # samples per frame: 1152 (MPEG-1) or 576 (MPEG-2/2.5) for Layer III
    factor = 144 if version == 3 else 72
    length = factor * kbps * 1000 // rate + padding
    channels = 1 if ((b3 >> 6) & 3) == 3 else 2
    return rate, channels, length


def mp3_stream_info(path: Path) -> tuple[int, int] | None:
    """(sample_rate, channels) of the first verified MP3 frame, or None.

    Skips a leading ID3v2 tag, then scans for a sync word whose computed
    frame length lands on another valid sync (two-frame verification
    against false syncs in tag or payload bytes).
    """
    with open(path, "rb") as fh:
        data = fh.read(256 * 1024)
    i = 0
    if data[:3] == b"ID3" and len(data) >= 10:
        i = 10 + ((data[6] << 21) | (data[7] << 14)
                  | (data[8] << 7) | data[9])
    while i + 4 <= len(data):
        frame = _mp3_frame_at(data, i)
        if frame is not None:
            rate, channels, length = frame
            nxt = i + length
            if nxt + 4 > len(data) or _mp3_frame_at(data, nxt) is not None:
                return rate, channels
        i += 1
    return None


_SDL_MIXER_LOCK = threading.Lock()


def _decode_mp3_sdl(path: Path) -> tuple[np.ndarray, int] | None:
    """MP3 through the platform codec (SDL_mixer through pygame), or None
    when pygame does not import.

    The mixer converts to its init format at load, so the frame header is
    parsed first and the mixer opened at the file's own rate: the decode is
    then not resampled. A lock serialises it (the mixer is process-global
    and decoders run in prefetch threads), and the mixer is closed again
    inside the lock: left open from a worker thread, SDL's exit-time
    teardown on the main thread can spin forever.
    """
    try:
        os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
        # the import-time banner would corrupt JSON-lines output
        os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
        import pygame.mixer as mixer
        import pygame.sndarray as sndarray
    except Exception:
        return None
    info = mp3_stream_info(path)
    if info is None:
        return None
    rate, channels = info
    with _SDL_MIXER_LOCK:
        try:
            mixer.init(frequency=rate, size=-16, channels=channels)
            sound = mixer.Sound(str(path))
            pcm = sndarray.array(sound)
        finally:
            mixer.quit()
    audio = pcm.astype(np.float32) / 32768.0
    if audio.ndim == 1:
        audio = audio[:, None]
    return audio.T, rate


def _decode_mp3(path: Path) -> tuple[np.ndarray, int] | None:
    """MP3 through ``minimp3py`` when it imports, else the SDL mixer."""
    try:
        import minimp3py
    except ImportError:
        return _decode_mp3_sdl(path)
    data, rate = minimp3py.read(str(path))
    return np.asarray(data, dtype=np.float32).T, int(rate)


_DECODERS: dict[str, Callable] = {".wav": _decode_wav,
                                  ".aiff": _decode_native,
                                  ".aif": _decode_native,
                                  ".flac": _decode_native,
                                  ".mp3": _decode_mp3}


def resample_audio(audio: np.ndarray, rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resample (C, T) float32 audio to the target rate (scipy's
    ``resample_poly`` at the rational rate ratio)."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(rate, target_rate)
    return resample_poly(audio, target_rate // g, rate // g,
                         axis=1).astype(np.float32)


def load_audio_file(path: Path | str,
                    target_rate: int = TARGET_SAMPLE_RATE,
                    resample: bool = False) -> np.ndarray | None:
    """Decode one WAV, AIFF, FLAC or MP3 file to stereo (2, T) float32 at
    the target rate.

    Files at other rates are dropped with a warning unless ``resample``
    (the codec CLI's setting) converts them; a file that does not decode
    warns and gives None, as does a type no decoder reads. A native decoder
    whose library does not build raises.
    """
    path = Path(path)
    decoder = _DECODERS.get(path.suffix.lower())
    if decoder is None:
        return None
    if decoder is _decode_native:
        native_mod.available()  # a failed build raises here, not per file
    try:
        decoded = decoder(path)
    except Exception as exc:  # one bad file must not stop a corpus pass
        warnings.warn(f"Failed to decode {path}: {exc}")
        return None
    if decoded is None:
        return None
    audio, rate = decoded
    if rate != target_rate:
        if not resample:
            warnings.warn(
                f"Skipping {path}: sample rate {rate} != {target_rate}")
            return None
        audio = resample_audio(audio, rate, target_rate)
    if audio.shape[0] == 1:
        audio = np.concatenate([audio, audio], axis=0)  # mono -> stereo dup
    return np.ascontiguousarray(audio[:2])


# ============================================================================
# Pipeline stages
# ============================================================================


def glob_audio_files(data_dir: str | Path, seed: int = 0) -> list[Path]:
    """Every decodable audio file under data_dir, shuffled by the seed."""
    root = Path(data_dir)
    files = sorted(p for ext in AUDIO_EXTENSIONS for p in root.rglob(f"*{ext}"))
    rng = np.random.default_rng(seed)
    rng.shuffle(files)
    return files


def load_audio_files(files: list[Path], prefetch: int = 2,
                     target_rate: int = TARGET_SAMPLE_RATE,
                     loop: bool = True,
                     resample: bool = False) -> Iterator[np.ndarray]:
    """Decode ``files`` in order, in a daemon worker thread that fills a
    *bounded blocking* queue of ``prefetch`` files; files that do not decode
    are skipped. ``prefetch=0`` decodes in the consumer, without a thread.

    A full pass in which *every* file is dropped (undecodable, or off-rate
    without ``resample``) raises RuntimeError instead of spinning forever.
    """
    if prefetch <= 0:
        return _load_audio_files_sync(files, target_rate, loop, resample)
    return _load_audio_files_threaded(files, prefetch, target_rate, loop,
                                      resample)


def _no_decodable_error(files, target_rate) -> RuntimeError:
    return RuntimeError(
        f"None of the {len(files)} audio files decoded to usable frames "
        f"(undecodable, or sample rate != {target_rate} with resample "
        "disabled — pass resample=True / config.resample_audio to convert)")


def _load_audio_files_sync(files, target_rate, loop, resample=False):
    while True:
        yielded = False
        for path in files:
            audio = load_audio_file(path, target_rate, resample=resample)
            if audio is not None:
                yielded = True
                yield audio
        if not yielded:
            raise _no_decodable_error(files, target_rate)
        if not loop:
            return


def _load_audio_files_threaded(files, prefetch, target_rate, loop,
                               resample=False):
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    _SENTINEL = object()
    _STARVED = object()
    failure: list[BaseException] = []  # the worker's error, raised here

    def put_checked(item) -> bool:
        """A blocking put that rechecks the stop flag, so a worker stuck on
        a full queue exits when the consumer drops the generator."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            while not stop.is_set():
                yielded = False
                for path in files:
                    if stop.is_set():
                        return
                    audio = load_audio_file(path, target_rate,
                                            resample=resample)
                    if audio is not None:
                        yielded = True
                        if not put_checked(audio):
                            return
                if not yielded:
                    put_checked(_STARVED)
                    return
                if not loop:
                    put_checked(_SENTINEL)
                    return
        except BaseException as exc:  # e.g. a failed native build
            failure.append(exc)
            put_checked(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if failure:
                    raise failure[0]
                return
            if item is _STARVED:
                raise _no_decodable_error(files, target_rate)
            yield item
    finally:
        stop.set()
        # drain, so a worker blocked in put() wakes and sees the flag; any
        # error: at interpreter shutdown the queue module may be gone
        try:
            while True:
                q.get_nowait()
        except BaseException:
            pass


def audio_to_frames(stream: Iterator[np.ndarray], frame_size: int,
                    seed: int = 0) -> Iterator[np.ndarray]:
    """Chop (C, T) streams into (frame_size, C) frames with a random prepend
    offset and zero padding."""
    rng = np.random.default_rng(seed)
    for audio in stream:
        channels, length = audio.shape
        offset = int(rng.integers(0, frame_size))
        padded_len = offset + length
        n_frames = -(-padded_len // frame_size)
        total = n_frames * frame_size
        buf = np.zeros((channels, total), dtype=np.float32)
        buf[:, offset:offset + length] = audio
        frames = buf.reshape(channels, n_frames, frame_size)
        for i in range(n_frames):
            yield np.ascontiguousarray(frames[:, i, :].T)  # (frame, C)


def buffer_shuffle(stream: Iterator[np.ndarray], buffer_size: int,
                   seed: int = 0) -> Iterator[np.ndarray]:
    """Reservoir shuffle with O(1) swap-and-pop eviction."""
    rng = np.random.default_rng(seed)
    buf: list[np.ndarray] = []
    for item in stream:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        idx = int(rng.integers(0, len(buf)))
        buf[idx], out = item, buf[idx]
        yield out
    rng.shuffle(buf)
    yield from buf


def batch(stream: Iterator[np.ndarray],
          batch_size: int) -> Iterator[np.ndarray]:
    """Stack every batch_size frames (a partial last batch is dropped)."""
    acc: list[np.ndarray] = []
    for item in stream:
        acc.append(item)
        if len(acc) == batch_size:
            yield np.stack(acc)
            acc = []


def build_audio_pipeline(data_dir: str | Path, seed: int = 0,
                         frame_size: int = DEFAULT_FRAME_SIZE,
                         prefetch: int = 2, buffer_size: int = 16,
                         batch_size: int = 32, loop: bool = True,
                         native: bool | None = None,
                         resample: bool = False) -> Iterator[np.ndarray]:
    """The whole pipeline over the audio files under ``data_dir``: yields
    ``[B, frame_size, 2]`` float32 batches.

    ``native=None`` takes the native loader (``data/native.py``: decode,
    framing, shuffle and ``max(1, prefetch)`` producer threads in C++) when
    every file has a native extension, and the Python stages otherwise;
    ``native=True`` takes it for any corpus, ``native=False`` never.
    ``resample=True`` converts off-rate files to 44.1 kHz in the Python
    stages instead of dropping them (the native loader has no resampler).
    """
    files = glob_audio_files(data_dir, seed)
    if not files:
        raise FileNotFoundError(f"No audio files under {data_dir}")
    if (native is None or native) and not resample:
        all_native = all(f.suffix.lower() in NATIVE_EXTENSIONS for f in files)
        if all_native or native:
            return iter(native_mod.NativeAudioLoader(
                files, frame_size=frame_size, channels=2,
                batch_size=batch_size,
                buffer_frames=max(buffer_size, 2 * batch_size),
                n_threads=max(1, prefetch), seed=seed, loop=loop))
    stream = load_audio_files(files, prefetch=prefetch, loop=loop,
                              resample=resample)
    stream = audio_to_frames(stream, frame_size, seed=seed)
    stream = buffer_shuffle(stream, buffer_size, seed=seed)
    return batch(stream, batch_size)

