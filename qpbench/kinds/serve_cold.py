"""Cold serving: each request is a direct solve, from nothing prepared, of
the next problem batch of a pool of ``pool`` made in set-up (first
requests, re-planning: scaling and factorization every time).  The loop's
iterations depend on the data, and a pool wide enough makes each seed's
mean request the same work.  The last answer on each of ``judge`` batches
of the pool, drawn from the seed, is judged."""

from __future__ import annotations

import random

from qpbench import data
from qpbench.judge import Judged


class Work:
    def __init__(self, cell, seed, device):
        tr, cfg = cell.traffic, cell.config
        self.solver = cell.solver
        self.opts = self.solver.config(cfg["options"])
        gen = data.generator(seed, device)
        self.pool = [data.make(cfg["problem"], int(tr["batch"]), gen, device)
                     for _ in range(int(tr["pool"]))]
        self.judge = set(random.Random(seed).sample(
            range(len(self.pool)), int(tr["judge"])))
        self.last = {}
        self.i = 0

    def unit(self) -> dict:
        k = self.i % len(self.pool)
        self.i += 1
        sol = self.solver.solve(self.pool[k], self.opts)
        if k in self.judge:
            self.last[k] = sol.x
        return {"iterations": sol.iterations,
                "failed": int(not bool(sol.converged.all()))}

    def warmup(self):
        # Every batch of the pool has the same shapes.
        for _ in range(2):
            self.unit()

    def judged(self):
        return [Judged(self.pool[k], x) for k, x in sorted(self.last.items())]

    def release(self):
        self.last = None


def setup(cell, seed, device) -> Work:
    return Work(cell, seed, device)
