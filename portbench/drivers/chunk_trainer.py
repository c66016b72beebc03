"""The trainer's chunk loop (``training/trainer.train_flow``'s hot loop with
a device replay pool): per chunk ``DeviceReplayPool.sample(k, batch)``,
``make_multi_step`` of ``k`` steps run with the trainer's generator and
with the noise and times the benchmark draws for the chunk, ``refresh()``,
then the metrics read back to the host.

The pool's source yields batches of a bank of seeded clips made at set-up,
in a seeded order, so its producer thread only copies. Set-up builds the
train state once; its first chunk is the window's own call on the pool's
batches, and is the chunk the check follows; a second chunk finds every
kernel built. The window goes on with that same state, whole chunks until
its seconds have passed, and ends at the synchronize that closes its last
chunk.

``correct``: the plain float32 reference follows the first chunk's ``k``
steps from the same weights on the same batches and draws. Compared: each
step's global gradient norm before the clip (the program's ``grad_norm``
series) against the reference's, the worst step's gap over the
reference's norm; the change of the parameters over the chunk, each leaf's
norm against the reference's, over the larger of that leaf's and the
median leaf's reference norm, the worst leaf counting (leaves whose first
reference gradient lies under a thousandth of the median leaf's are left
out); and that every row trained on is a bank clip. Each step's loss is
read, and not compared.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import program, traffic_gen
from portbench.drivers.common import Phases, Sizes, now, sync
from portbench.reference import imf
from portbench.reference.layers import FP8Ops, Ops

WIRE_SCALE = 1.1  # the pool's int16 wire format: full scale at 1.1


def wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` through int16 at full scale ``WIRE_SCALE`` and back."""
    q = torch.clamp(x * (32767.0 / WIRE_SCALE), -32767.0, 32767.0).trunc()
    return q * (WIRE_SCALE / 32767.0)


class Driver:
    def __init__(self, run):
        self.run = run
        self.sizes = Sizes(run.config)
        tpu = self.sizes.config["tpu"]
        self.k = tpu["steps_per_call"]
        self.rows_per_step = self.sizes.batch * self.sizes.frames(self.sizes.frame_size)

    def _source(self):
        bank, batch, seed = self.host_bank, self.sizes.batch, self.run.seed
        epoch = 0
        while True:
            order = traffic_gen.rng(seed, 100 + epoch).permutation(len(bank))
            for i in range(0, len(order) - batch + 1, batch):
                yield bank[order[i:i + batch]]
            epoch += 1

    def _draws(self, k: int, gen: torch.Generator):
        """Noise and an ordered (t, r) pair per row for ``k`` steps: t, r
        logit-normal(-0.4, 1); the first half of the rows r = t, the next
        quarter (t, r) = (1, 0) (the config's proportions)."""
        rows, d, dev = self.rows_per_step, self.sizes.geo.noise_dim, self.run.device
        method = self.sizes.config["method"]
        noise = torch.randn((k, rows, d), generator=gen, device=dev)
        pair = torch.sigmoid(torch.randn((k, rows, 2), generator=gen, device=dev) - 0.4)
        t, r = pair.max(dim=-1, keepdim=True)[0], pair.min(dim=-1, keepdim=True)[0]
        n_data = int(rows * 0.5)
        n_full = int(rows * method.get("time_sampling_full_proportion", 0.0))
        r[:, :n_data] = t[:, :n_data]
        t[:, n_data:n_data + n_full] = 1.0
        r[:, n_data:n_data + n_full] = 0.0
        return noise, t, r

    def setup(self) -> None:
        run, s, dev = self.run, self.sizes, self.run.device
        phase = Phases()
        self.params = s.family.draw(s.geo, run.seed, dev)
        bank = traffic_gen.clip_bank(run.seed, run.traffic["bank_clips"],
                                     s.frame_size, s.sample_rate, dev)
        self.host_bank = bank.cpu().numpy()
        phase("weights and bank")
        self.trainer = program.Trainer(program.port_config(s.config), self.params,
                                       s.family.to_port, self._source(), run.seed, dev)
        phase("train state and pool")
        self.generator = traffic_gen.torch_generator(run.seed, 6, dev)
        self.draw_gen = traffic_gen.torch_generator(run.seed, 7, dev)
        series, self.batches, self.draws = self._chunk(keep=True)
        self.losses = [float(v) for v in series["loss"]]
        self.grad_norms = [float(v) for v in series["grad_norm"]]
        tr = self.trainer
        self.after = {s.family.ref_name(n): p.detach().clone()
                      for n, p in zip(tr.names(), tr.state.params)}
        phase("the checked chunk")
        self._chunk()
        sync(dev)
        phase("one warm chunk")

    def _chunk(self, keep: bool = False):
        """One chunk; returns its metrics on the host and, with ``keep``,
        its batches and draws."""
        tr, spans, s = self.trainer, self.run.spans, self.sizes
        with spans("sample"):
            stacked = tr.pool.sample(self.k, s.batch)
        with spans("draws"):
            noise, t, r = self._draws(self.k, self.draw_gen)
        batches = [b.clone() for b in stacked] if keep else None
        with spans("chunk"):
            tr.state, series = tr.chunk(self.k)(tr.state, stacked, self.generator,
                                                noise=noise, t=t, r=r)
        with spans("refresh"):
            tr.pool.refresh()
        with spans("readback"):
            series = {name: value.cpu().numpy() for name, value in series.items()}
        draws = [(noise[i], t[i], r[i]) for i in range(self.k)] if keep else None
        return series, batches, draws

    def window(self, seconds: float) -> dict:
        run, dev = self.run, self.run.device
        run.spans.on = run.trace
        sync(dev)
        t0_ns, t0 = time.time_ns(), now()
        steps = skipped = 0
        while True:
            ok = self._chunk()[0].get("update_ok")
            skipped += 0 if ok is None else int(np.sum(~ok.astype(bool)))
            steps += self.k
            if now() - t0 >= seconds:
                break
        sync(dev)
        elapsed, t1_ns = now() - t0, time.time_ns()
        run.spans.on = False
        rows = steps * self.rows_per_step
        return {"end_to_end": {"train_frames_per_s": rows / elapsed},
                "attempted": steps, "failed": skipped, "t0_ns": t0_ns,
                "t1_ns": t1_ns, "elapsed_s": elapsed, "steps": steps, "rows": rows,
                "sizes": self.sizes}

    def free_program(self) -> None:
        self.trainer.close()
        del self.trainer

    def _check_feed(self) -> bool:
        """Every row the steps trained on is a bank clip through the pool's
        int16 wire format."""
        bank = wire(torch.from_numpy(self.host_bank).to(self.run.device))
        keys = bank[:, :64].reshape(len(bank), -1)
        for batch in self.batches:
            rows = batch.reshape(len(batch), -1)
            hit = torch.cdist(rows[:, :128], keys).argmin(dim=1)
            if not torch.allclose(batch, bank[hit], rtol=0, atol=1e-6):
                return False
        return True

    def check(self) -> dict:
        s, ops = self.sizes, Ops()
        fam, optim = s.family, dict(s.config["base"])
        ref = imf.train_steps(fam, self.params, self.batches, self.draws, s.geo,
                              s.tok(), optim, ops)
        got = {"losses": self.losses, "grad_norms": self.grad_norms,
               "params": self.after}
        control = self.run.control
        if control == "fp8":  # the float8 reference in the program's place
            got = imf.train_steps(fam, self.params, self.batches, self.draws, s.geo,
                                  s.tok(), optim, FP8Ops())
        elif control == "half":  # the reference on half of each batch
            half = [b[:len(b) // 2] for b in self.batches]
            rows = self.rows_per_step // 2
            draws = [tuple(d[:rows] for d in draw) for draw in self.draws]
            got = imf.train_steps(fam, self.params, half, draws, s.geo, s.tok(), optim,
                                  ops)
        numbers = {"feed_rows_from_bank": 0.0 if self._check_feed() else 1.0,
                   "loss_gap": max(abs(a - b) / abs(b)
                                   for a, b in zip(got["losses"], ref["losses"])),
                   "grad_norm_gap": max(abs(a - b) / b for a, b in
                                        zip(got["grad_norms"], ref["grad_norms"]))}
        first, before = ref["first_grad"], self.params
        gnorm = {n: float(g.norm()) for n, g in first.items()}
        gmed = statistics.median(gnorm.values())
        moved = [n for n in first if gnorm[n] >= 1e-3 * gmed]
        change = {n: float((ref["params"][n] - before[n]).norm()) for n in moved}
        cmed = statistics.median(change.values())
        numbers["change_gap"] = max(
            abs(float((got["params"][n] - before[n]).norm()) - change[n]) / max(change[n], cmed)
            for n in moved)
        numbers["leaves_left_out"] = float(len(first) - len(moved))
        return numbers
