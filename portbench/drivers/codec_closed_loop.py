"""Closed loop of back-to-back codec round trips (``AudioCodec.roundtrip``).

Each call sends ``clips_per_call`` clips of ``clip_seconds`` seconds, drawn
in turn from a bank of seeded clips made at set-up, with start noise drawn
in turn from a seeded bank, and waits for the card once (one synchronize a
call). The window runs whole calls until its seconds have passed; the rate
is the audio seconds of all its calls over all its time. In the traced run
the encode and the decode are separate spans, each ending in a synchronize.

``correct``: a seeded sample of the window's calls is kept and, once the
window has closed, compared clip by clip with the plain float32 reference
run on the same clips and noise (the widest relative L2 gap of a clip).
"""

from __future__ import annotations

import time

import torch

from portbench import program, traffic_gen
from portbench.drivers.common import Phases, Reservoir, Sizes, now, rel_l2, sync
from portbench.reference import imf


class Driver:
    def __init__(self, run):
        self.run = run
        self.sizes = Sizes(run.config)
        t = run.traffic
        self.clips = t["clips_per_call"]
        self.samples = int(t["clip_seconds"] * self.sizes.sample_rate)
        self.bank_calls, self.noise_draws = t["bank_calls"], t["noise_draws"]
        self.rows = self.clips * self.sizes.frames(self.samples)

    def setup(self) -> None:
        run, s, dev = self.run, self.sizes, self.run.device
        phase = Phases()
        self.params = s.family.draw(s.geo, run.seed, dev)
        self.codec = program.codec(program.port_config(s.config), self.params,
                                   s.family.to_port, dev, quantized=run.control == "int8")
        phase("weights and codec")
        self.bank = traffic_gen.clip_bank(run.seed, self.clips * self.bank_calls,
                                          self.samples, s.sample_rate, dev)
        gen = traffic_gen.torch_generator(run.seed, 4, dev)
        self.noise = torch.randn((self.noise_draws, self.rows, s.geo.noise_dim),
                                 generator=gen, device=dev)
        self.kept = Reservoir(self.run.traffic["check_calls"],
                              traffic_gen.rng(run.seed, 5))
        phase("banks")
        for i in range(2):  # every shape the window uses, twice
            self._call(i)
        self.done = 0  # calls made in the windows
        sync(dev)
        phase("two warm calls")

    def _inputs(self, i: int):
        b = i % self.bank_calls
        return (self.bank[b * self.clips:(b + 1) * self.clips],
                self.noise[i % self.noise_draws])

    def _call(self, i: int) -> torch.Tensor:
        audio, noise = self._inputs(i)
        spans, dev = self.run.spans, self.run.device
        if not spans.on:
            return self.codec.roundtrip(audio, noise=noise)
        with spans("encode", sync=dev):
            latents, gains = self.codec.encode_with_gains(audio)
        with spans("decode", sync=dev):
            return self.codec.decode(latents, noise=noise,
                                     gains=gains if self.sizes.gain_norm else None)

    def window(self, seconds: float) -> dict:
        run, dev = self.run, self.run.device
        run.spans.on = run.trace
        sync(dev)
        t0_ns, t0 = time.time_ns(), now()
        calls = 0
        while True:
            out = self._call(self.done)
            sync(dev)
            self.kept.offer((self.done, out))
            calls += 1
            self.done += 1
            if now() - t0 >= seconds:
                break
        elapsed, t1_ns = now() - t0, time.time_ns()
        run.spans.on = False
        audio_s = calls * self.clips * self.samples / self.sizes.sample_rate
        return {"end_to_end": {"codec_audio_s_per_s": audio_s / elapsed},
                "attempted": calls, "failed": 0, "t0_ns": t0_ns, "t1_ns": t1_ns,
                "elapsed_s": elapsed, "calls": calls, "rows": calls * self.rows,
                "samples": self.samples,
                "clips": self.clips, "sizes": self.sizes}

    def free_program(self) -> None:
        del self.codec

    def check(self) -> dict:
        s = self.sizes
        worst = 0.0
        for i, out in self.kept.items:
            audio, noise = self._inputs(i)
            ref = imf.roundtrip(s.family, self.params, audio, noise, s.geo, s.window,
                                s.hop, s.coeff_scale, s.gain_norm)
            if out.shape != ref.shape:
                return {"audio_rel_l2": float("inf")}
            worst = max(worst, float(rel_l2(out, ref).max()))
        return {"audio_rel_l2": worst}
