"""The comparison that decides ``correct``.

Each judged answer (a batch of solves, with the gradients where the timed
path made them) is held against the configuration's plain reference, run in
blocks of elements after the window:

- ``x_err``: the largest |x - x*| over every element and coordinate;
- ``dp_err_p90``, ``dQ_err_p90``, ``dp_err_max``, ``dQ_err_max``: per
  element, the largest entry of the gradient's error over the largest entry
  of the reference's gradient; their 90th percentile and their largest,
  over the elements whose active set the problem determines (reference
  margin at least the check's ``margin``, a few times the port's accuracy
  in x; see ``reference.margin``).  Where a coordinate sits closer to the
  edge of its bound than that, the solution map has no derivative and a
  solve at the configuration's tolerance may take either one-sided one.

The numbers are compared with the limits of ``checks/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from qpbench.data import Problem


@dataclasses.dataclass
class Judged:
    problem: Problem
    x: torch.Tensor
    dp: Optional[torch.Tensor] = None
    dQ: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None


def _max(a, b):
    """max that keeps a NaN (Python's max drops one in second place)."""
    return a if math.isnan(a) else b if math.isnan(b) else max(a, b)


def _worst(err, ref):
    """Per element: the largest |err| over the largest |ref|."""
    dims = tuple(range(1, err.ndim))
    return err.abs().amax(dims) / ref.abs().amax(dims).clamp(min=1e-300)


def readings(ref, items, margin: float, block: int = 64) -> dict:
    """The numbers compared, over every judged answer; ``ref`` is the
    reference module.  ``degenerate`` counts the elements left out of the
    gradients' numbers."""
    out = {"x_err": 0.0}
    errs = {"dp": [], "dQ": []}
    for it in items:
        B = it.x.shape[0]
        for i in range(0, B, block):
            sl = slice(i, min(i + block, B))
            d = it.problem.rows(sl)
            sol = ref.solve(*d)
            out["x_err"] = _max(out["x_err"], float(
                (it.x[sl].double() - sol.x).abs().amax()))
            if it.dp is None:
                continue
            keep = ref.margin(sol) >= margin
            out["degenerate"] = out.get("degenerate", 0) + int(
                (~keep).sum())
            v = ref.grad_p(d.Q, d.A, sol, it.w[sl])
            e_dp = _worst(it.dp[sl].double() - v, v)
            dQ = ref.grad_q(v, sol.x)
            e_dQ = _worst(it.dQ[sl].double() - dQ, dQ)
            del dQ
            errs["dp"].append(e_dp[keep])
            errs["dQ"].append(e_dQ[keep])
    for key, es in errs.items():
        if es:
            e = torch.cat(es)
            # A NaN anywhere is no gradient at all: the number reads NaN.
            bad = not e.numel() or bool(torch.isnan(e).any())
            out[f"{key}_err_p90"] = (math.nan if bad
                                     else float(torch.quantile(e, 0.9)))
            out[f"{key}_err_max"] = math.nan if bad else float(e.max())
    return out


def verdict(reads: dict, checks: dict):
    """``(correct, [(name, value, limit), ...])``: every limited number is
    present, finite and at most its limit."""
    rows, ok = [], True
    for name, spec in checks["limits"].items():
        value = reads.get(name)
        limit = float(spec["limit"])
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
