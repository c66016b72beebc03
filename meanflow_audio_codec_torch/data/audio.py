"""Synthetic audio sources, host-side batch pools, WAV input and output.

Counterpart of the synthetic part of ``meanflow_audio_codec_tpu/data/audio.py``
(the ``tonal``, ``rich``, ``speech``, ``mixed`` and ``mixed2`` families,
``synthetic_pipeline_for_family``, ``replay_pool_batches``,
``prefetch_batches`` and ``write_wav``), copied as it is: plain numpy with
seeded ``default_rng`` generators, so the same seed gives the same batches,
bit for bit, in both packages. Batches are float32 ``[B, frame_size, 2]``.
File input for the codec CLI is ``load_audio_file`` on WAV, with the
polyphase ``resample_audio``.

The disk corpora (``build_audio_pipeline``, the native loader) and the AIFF,
FLAC and MP3 decoders are not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import queue
import threading
import warnings
import wave
from pathlib import Path
from typing import Iterator

import numpy as np

TARGET_SAMPLE_RATE = 44100
DEFAULT_FRAME_SIZE = 256 * 256 * 3  # ~4.46 s @ 44.1 kHz
#: file types the JAX package decodes through its native loader or SDL
_UNPORTED_EXTENSIONS = (".aiff", ".aif", ".flac", ".mp3")


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
    """Decode one WAV file to stereo (2, T) float32 at the target rate.

    Files at other rates are dropped with a warning unless ``resample``
    (the codec CLI's setting) converts them; a file that does not decode
    warns and gives None, as does a type no loader reads. AIFF, FLAC and MP3
    raise ``NotImplementedError``: their decoders are not ported yet.
    """
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in _UNPORTED_EXTENSIONS:
        raise NotImplementedError(
            f"{suffix} input is not ported yet (ROADMAP queue 1 item 8: the "
            "native loader); convert the file to WAV")
    if suffix != ".wav":
        return None
    try:
        decoded = _decode_wav(path)
    except (wave.Error, EOFError, OSError, ValueError) as exc:
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
