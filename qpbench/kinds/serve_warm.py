"""Warm serving (MPC, portfolio re-solves): Q, A, b and the bounds are
fixed and prepared once in set-up; each request moves p and is solved
against the preparation, warm-started from the previous answer.  p follows
a stationary drift, p <- sqrt(1 - d^2) p + d xi with xi ~ N(0, 1) and
d = ``drift``, so every request is a draw of the same family and each moves
p by about d (experiment_serving.py's 2% drift, kept from wandering off).
The last request and one drawn from the seed among the first
``sample_within`` are judged."""

from __future__ import annotations

import math
import random

import torch

from qpbench import data
from qpbench.judge import Judged


class Work:
    def __init__(self, cell, seed, device):
        tr, cfg = cell.traffic, cell.config
        self.solver = cell.solver
        self.opts = self.solver.config(cfg["options"])
        self.gen = data.generator(seed, device)
        self.base = data.make(cfg["problem"], int(tr["batch"]), self.gen,
                              device)
        self.prep = self.solver.prepare(self.base, self.opts)
        self.d = float(tr["drift"])
        self.keep = math.sqrt(1.0 - self.d ** 2)
        self.p = self.base.p
        self.sol = self.solver.solve_prepared(self.prep, self.p, self.opts)
        self.sample = random.Random(seed).randrange(int(tr["sample_within"]))
        self.kept = {}
        self.i = -int(tr["warmup"])

    def unit(self) -> dict:
        xi = torch.randn(self.p.shape, generator=self.gen,
                         dtype=self.p.dtype, device=self.p.device)
        self.p = self.keep * self.p + self.d * xi
        self.sol = self.solver.solve_prepared(self.prep, self.p, self.opts,
                                              warm=self.sol)
        if self.i == self.sample:
            self.kept["sample"] = (self.p, self.sol.x)
        self.kept["last"] = (self.p, self.sol.x)
        self.i += 1
        return {"iterations": self.sol.iterations,
                "failed": int(not bool(self.sol.converged.all()))}

    def warmup(self):
        while self.i < 0:
            self.unit()

    def judged(self):
        return [Judged(self.base._replace(p=p), x)
                for p, x in self.kept.values()]

    def release(self):
        self.prep = self.sol = None


def setup(cell, seed, device) -> Work:
    return Work(cell, seed, device)
