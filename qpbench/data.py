"""Problem data from a seed, made on the device.

Each problem family is a module ``problems/<generator>.py`` with
``make(spec, batch, gen, device) -> Problem``.  The program and the
reference get the same tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from qpbench import harness


class Problem(NamedTuple):
    Q: torch.Tensor                 # (B, n, n)
    p: torch.Tensor                 # (B, n)
    A: Optional[torch.Tensor]       # (B, m, n)
    b: Optional[torch.Tensor]       # (B, m)
    lb: torch.Tensor                # (B, n)
    ub: torch.Tensor                # (B, n)

    def rows(self, sl: slice) -> "Problem":
        return Problem(*(None if t is None else t[sl] for t in self))


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number that
    fits in 64 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


def make(spec: dict, batch: int, gen: torch.Generator, device) -> Problem:
    """A batch of the family that ``spec["generator"]`` names
    (``problems/<generator>.py``), from ``gen``'s stream."""
    return harness.load_module("problems", spec["generator"]).make(
        spec, batch, gen, device)
