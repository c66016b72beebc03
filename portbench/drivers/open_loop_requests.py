"""Open loop of single-clip decode requests (``AudioCodec.decode``) at a
fixed Poisson rate.

A request is one clip's latents and gains (``[1, nf, latent]``, ``[1, nf,
1]``) with its start noise, cut at a seeded offset from banks of seeded
frames made at set-up; its duration is whole seconds drawn from the
traffic file's lognormal, and the gaps between arrivals are drawn from the
exponential (``traffic_gen``). One server takes the requests in order of arrival:
it waits for a request's due time when idle, decodes it and copies the
audio to the host. A request's latency runs from its due time to its audio
on the host, so a stall counts against every request queued behind it.
The schedule covers the window's seconds; requests still open when it ends
are drained and counted. Set-up decodes each duration the schedules hold
once.

``correct``: a seeded sample of the requests, with the longest, is kept and
compared once the window has closed with the plain float32 reference's
decode of the same latents, gains and noise (the widest relative L2 gap).
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from portbench import program, traffic_gen
from portbench.drivers.common import Phases, Sizes, now, rel_l2, sync
from portbench.reference import imf


class Driver:
    def __init__(self, run):
        self.run = run
        self.sizes = Sizes(run.config)
        self.rate = run.traffic["rate_per_s"]
        self.windows = 0
        self.outputs = {}  # (window, request) -> audio on the host
        self.expected = 0  # requests kept for the check

    def schedule(self, seconds: float, window: int):
        """(arrival s, frames, bank offset) per request of a window of
        ``seconds``, and the ids of the requests kept for the check."""
        t, seed = self.run.traffic, self.run.seed + 7919 * window
        count = max(1, round(self.rate * seconds))
        durations = traffic_gen.durations(seed, count, t["median_s"], t["sigma"],
                                          t["min_s"], t["max_s"])
        frames = [self.sizes.frames(d * self.sizes.sample_rate) for d in durations]
        rng = traffic_gen.rng(seed, 9)
        offsets = [int(rng.integers(0, self.bank - nf + 1)) for nf in frames]
        sample = rng.choice(count, size=min(count, t["check_requests"]), replace=False)
        kept = set(int(i) for i in sample) | {max(range(count), key=frames.__getitem__)}
        arrivals = traffic_gen.arrivals(seed, self.rate, count)
        requests = list(zip(arrivals, frames, offsets))
        return requests, kept

    def setup(self) -> None:
        run, s, dev = self.run, self.sizes, self.run.device
        phase = Phases()
        self.params = s.family.draw(s.geo, run.seed, dev)
        self.codec = program.codec(program.port_config(s.config), self.params,
                                   s.family.to_port, dev, quantized=run.control == "int8")
        phase("weights and codec")
        self.bank = 2 * s.frames(run.traffic["max_s"] * s.sample_rate)
        gen = traffic_gen.torch_generator(run.seed, 8, dev)
        self.latents = torch.randn((self.bank, *s.family.latent_shape(s.geo)),
                                   generator=gen, device=dev)
        self.gains = torch.exp(0.5 * torch.randn((self.bank, 1), generator=gen, device=dev) - 2.0)
        self.noise = torch.randn((self.bank, s.geo.noise_dim), generator=gen, device=dev)
        # every duration the run's windows (one, or two halves traced) hold
        shapes = set()
        for seconds, windows in ((run.seconds, 1), (run.seconds / 2, 2)):
            for w in range(windows):
                shapes |= {nf for _, nf, _ in self.schedule(seconds, w)[0]}
        # the audio lands in one pinned buffer, as a server's staging area
        longest = s.frames(run.traffic["max_s"] * s.sample_rate)
        samples = (longest - 1) * s.hop + 2 * s.window
        self.staging = torch.empty(samples * 2, pin_memory=dev.type == "cuda")
        phase("banks and schedules")
        for nf in sorted(shapes):
            out = self._decode(0, nf)
            self.staging[:out.numel()].view(out.shape).copy_(out)
        sync(dev)
        phase(f"warm-up of {len(shapes)} shapes")

    def _inputs(self, offset: int, nf: int):
        span = slice(offset, offset + nf)
        return self.latents[span][None], self.gains[span][None], self.noise[span]

    def _decode(self, offset: int, nf: int) -> torch.Tensor:
        latents, gains, noise = self._inputs(offset, nf)
        return self.codec.decode(latents, gains=gains, noise=noise)

    def window(self, seconds: float) -> dict:
        run, spans = self.run, self.run.spans
        requests, kept = self.schedule(seconds, self.windows)
        self.windows += 1
        spans.on = run.trace
        sync(run.device)
        t0_ns, t0 = time.time_ns(), now()
        latency, service, late, failed = [], [], [], 0
        for i, (due, nf, offset) in enumerate(requests):
            wait = t0 + due - now()
            if wait > 0:
                with spans("wait"):
                    time.sleep(wait)
                late.append(now() - t0 - due)
            start = now()
            try:
                with spans("decode"):
                    out = self._decode(offset, nf)
                with spans("to_host"):
                    audio = self.staging[:out.numel()].view(out.shape)
                    audio.copy_(out)
            except RuntimeError as exc:  # a failed request misses every limit
                print(f"request {i} failed: {exc!r}", file=sys.stderr)
                failed += 1
                latency.append(math.inf)
                continue
            done = now()
            latency.append(done - t0 - due)
            service.append(done - start)
            if i in kept:
                self.outputs[(self.windows - 1, i)] = (offset, nf, audio.clone())
        elapsed, t1_ns = now() - t0, time.time_ns()
        spans.on = False
        p95 = statistics.quantiles(latency, n=100, method="inclusive")[94]
        self.expected += len(kept)
        return {"end_to_end": {"request_ms_p95": 1000.0 * p95},
                "attempted": len(latency), "failed": failed, "t0_ns": t0_ns,
                "t1_ns": t1_ns, "elapsed_s": elapsed, "service_s": service,
                "latency_s": latency, "late_s": late,
                "rows": sum(nf for _, nf, _ in requests), "sizes": self.sizes}

    def free_program(self) -> None:
        del self.codec

    def check(self) -> dict:
        s, worst = self.sizes, 0.0
        if len(self.outputs) != self.expected:
            return {"audio_rel_l2": math.inf}
        for offset, nf, audio in self.outputs.values():
            latents, gains, noise = self._inputs(offset, nf)
            ref = imf.decode(s.family, self.params, latents, gains, noise, s.geo,
                             s.window, s.hop, s.coeff_scale)
            out = audio.to(ref.device)
            if out.shape != ref.shape:
                return {"audio_rel_l2": math.inf}
            worst = max(worst, float(rel_l2(out, ref).max()))
        return {"audio_rel_l2": worst}
