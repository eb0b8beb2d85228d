"""Cells of the manifest cut to a size a CPU test holds: the same
configuration and traffic files, with n_x and the batch made small."""

from __future__ import annotations

import torch

from qpbench import harness
from qpbench.run import run_cell

N_X, BATCH = 48, 6
SEED = 2 ** 31 + 77


def cell(name: str) -> harness.Cell:
    c = harness.Cell(name)
    c.config["problem"]["n_x"] = N_X
    c.traffic["batch"] = BATCH
    c.traffic["trace_units"] = 2
    if "sample_within" in c.traffic:
        c.traffic["sample_within"] = 3
    if "pool" in c.traffic:
        c.traffic["pool"] = 3
    return c


def run(name: str, trace: bool = False, seed: int = SEED, seconds=0.3):
    torch.set_num_threads(2)
    return run_cell(cell(name), seed, seconds, trace, torch.device("cpu"))
