"""Experiment 1's problems (Butler & Kwon, arXiv:2112.07464): a frozen copy
of the distributions of ``create_qp_data`` (ipo-lab/lqp_py
experiments/utils.py): Q = L'L / n_samples with L standard normal
(n_samples, n_x), p standard normal, one sum-to-one equality row, and box
bounds lb = -U[lo, hi], ub = U[lo, hi].  Q is exactly symmetric."""

from __future__ import annotations

import torch

from qpbench.data import Problem

#: Elements of Q made per call, so the (chunk, n_samples, n) draw of L stays
#: small next to Q itself.
_CHUNK = 64


def make(spec: dict, batch: int, gen: torch.Generator, device) -> Problem:
    """One batch of Experiment 1's problems from ``gen``'s stream."""
    n = int(spec["n_x"])
    ns = int(spec.get("n_samples", 2 * n))
    lo, hi = (float(v) for v in spec["box"])
    dtype = getattr(torch, spec["dtype"])
    kw = dict(dtype=dtype, device=device)
    Q = torch.empty((batch, n, n), **kw)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        for i in range(0, batch, _CHUNK):
            L = torch.randn((min(_CHUNK, batch - i), ns, n), generator=gen,
                            **kw)
            S = torch.matmul(L.mT, L)
            # S + S' is symmetric to the bit, whatever order the product
            # summed in: the solvers take Q as symmetric (no
            # symmetrization pass, as in experiment_1.py).
            torch.add(S, S.mT, out=Q[i:i + L.shape[0]])
            del S
        Q /= 2 * ns
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    p = torch.randn((batch, n), generator=gen, **kw)
    m = int(spec["n_eq"])
    A = torch.ones((batch, m, n), **kw) if m else None
    b = torch.ones((batch, m), **kw) if m else None
    lb = -(lo + (hi - lo) * torch.rand((batch, n), generator=gen, **kw))
    ub = lo + (hi - lo) * torch.rand((batch, n), generator=gen, **kw)
    return Problem(Q, p, A, b, lb, ub)


