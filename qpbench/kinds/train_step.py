"""A training step through a QP layer: forward and backward with respect
to Q and p of the loss sum(w * x), with w ~ N(0, 1) drawn once from the
seed (sum(x) would give dp = 0 under a sum-to-one row).  Set-up makes a
pool of ``pool`` problem batches of ``batch`` elements, which the steps
cycle through: the loop's iterations depend on the data, and a pool wide
enough makes each seed's mean step the same work.  The last step on each
of ``judge`` batches of the pool, drawn from the seed, is judged: its x,
dp and dQ.  Every step reports whether its forward solve converged."""

from __future__ import annotations

import random

import torch

from qpbench import data
from qpbench.judge import Judged


class Work:
    def __init__(self, cell, seed, device):
        tr, cfg = cell.traffic, cell.config
        self.solver = cell.solver
        self.opts = self.solver.config(cfg["options"])
        gen = data.generator(seed, device)
        self.pool = []
        for _ in range(int(tr["pool"])):
            d = data.make(cfg["problem"], int(tr["batch"]), gen, device)
            d.Q.requires_grad_(True)
            d.p.requires_grad_(True)
            self.pool.append(d)
        self.w = torch.randn(self.pool[0].p.shape, generator=gen,
                             dtype=self.pool[0].p.dtype, device=device)
        self.judge = set(random.Random(seed).sample(
            range(len(self.pool)), int(tr["judge"])))
        self.last = {}
        self.i = 0
        self.timing = device.type == "cuda"

    def _events(self, n):
        return ([torch.cuda.Event(enable_timing=True) for _ in range(n)]
                if self.timing else None)

    def unit(self) -> dict:
        k = self.i % len(self.pool)
        self.i += 1
        d = self.pool[k]
        ev = self._events(3)
        if ev:
            ev[0].record()
        x, ok = self.solver.layer(d, self.opts)
        if ev:
            ev[1].record()
        dQ, dp = torch.autograd.grad((self.w * x).sum(), (d.Q, d.p))
        if ev:
            ev[2].record()
        if k in self.judge:
            self.last[k] = (x.detach(), dp, dQ)
        # The forward's convergence, read after the unit's synchronize.
        rec = {"failed": 1 if ok is None else ~ok}
        if ev:
            rec.update(fwd_ms=ev[:2], bwd_ms=ev[1:])
        return rec

    def warmup(self):
        # Every batch of the pool has the same shapes.
        for _ in range(2):
            self.unit()

    def judged(self):
        return [Judged(data.Problem(*(None if t is None else t.detach()
                                      for t in self.pool[k])), x, dp, dQ,
                       self.w)
                for k, (x, dp, dQ) in sorted(self.last.items())]

    def release(self):
        self.last = None


def setup(cell, seed, device) -> Work:
    return Work(cell, seed, device)
