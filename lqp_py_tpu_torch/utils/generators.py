"""Deterministic QP problem generators (counterpart of
``lqp_py_tpu.utils.generators``): ``create_qp_data`` (well-conditioned
box QPs with one sum-to-one row) and ``generate_hard_qp`` (sparse,
ill-conditioned Q with sparse equality rows).

The distributions are the JAX package's; the streams are not: a
``torch.Generator`` seeded with the same integer draws other numbers than
``jax.random``.  The tensors are made on ``device``, the card unless the
caller names another.  Tests that compare the two packages make their data once
(with numpy or the JAX generators) and hand it to both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lqp_py_tpu_torch.ops.precision import highest_matmul_precision


class QPData(NamedTuple):
    Q: torch.Tensor
    p: torch.Tensor
    A: Optional[torch.Tensor]
    b: Optional[torch.Tensor]
    lb: torch.Tensor
    ub: torch.Tensor

    def with_G_h(self):
        """The box as ``G = [-I; I]``, ``h = [-lb; ub]`` for the
        general-inequality solvers, on the data's device and dtype.  G is a
        batch-expanded view of one (2n, n) matrix: read it, never write
        into it."""
        B, n = self.Q.shape[0], self.Q.shape[-1]
        eye = torch.eye(n, dtype=self.Q.dtype, device=self.Q.device)
        G = torch.cat([-eye, eye], dim=0).expand(B, 2 * n, n)
        return G, torch.cat([-self.lb, self.ub], dim=-1)


def create_qp_data(n_x: int, n_batch: int, n_samples: Optional[int] = None,
                   seed: int = 0, dtype=torch.float32,
                   device=torch.device("cuda")) -> QPData:
    """Well-conditioned random box QPs: SPD Q = L'L/n_samples, a
    sum-to-one equality row, box bounds uniform in +/-[1, 2]."""
    if n_samples is None:
        n_samples = 2 * n_x
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    L = torch.randn((n_batch, n_samples, n_x), generator=g, **kw)
    with highest_matmul_precision():
        Q = (L.mT @ L) / n_samples
    del L
    p = torch.randn((n_batch, n_x), generator=g, **kw)
    A = torch.ones((n_batch, 1, n_x), **kw)
    b = torch.ones((n_batch, 1), **kw)
    lb = -(1.0 + torch.rand((n_batch, n_x), generator=g, **kw))
    ub = 1.0 + torch.rand((n_batch, n_x), generator=g, **kw)
    return QPData(Q=Q, p=p, A=A, b=b, lb=lb, ub=ub)


def generate_hard_qp(n_x: int, n_batch: int, prob: float = 0.15,
                     seed: int = 0, dtype=torch.float64,
                     device=torch.device("cuda")) -> QPData:
    """Hard QP set: masked-normal Q = M'M + 1e-2 I, round(sqrt(n_x)) sparse
    equality rows (an all-zero row gets its first entry forced on), and
    bounds x0 -/+ U(0, 1) around a point x0 with A x0 = b."""
    m = max(round(n_x ** 0.5), 1)
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    shape_q = (n_batch, n_x, n_x)
    M = torch.randn(shape_q, generator=g, **kw)
    M *= torch.rand(shape_q, generator=g, **kw) < prob
    with highest_matmul_precision():
        Q = M.mT @ M + 1e-2 * torch.eye(n_x, **kw)
    del M
    p = torch.randn((n_batch, n_x), generator=g, **kw)
    x0 = torch.randn((n_batch, n_x), generator=g, **kw)
    A = torch.randn((n_batch, m, n_x), generator=g, **kw)
    amask = torch.rand((n_batch, m, n_x), generator=g, **kw) < prob
    amask[..., 0] |= ~amask.any(dim=-1)
    A = A * amask
    with highest_matmul_precision():
        b = (A @ x0[..., None])[..., 0]
    lb = x0 - torch.rand((n_batch, n_x), generator=g, **kw)
    ub = x0 + torch.rand((n_batch, n_x), generator=g, **kw)
    return QPData(Q=Q, p=p, A=A, b=b, lb=lb, ub=ub)


@highest_matmul_precision()
def kkt_residuals(Q, p, A, b, lb, ub, x, lams, nus):
    """Solver-independent optimality oracle: stationarity, feasibility and
    complementarity residuals of a box-QP solution (infinity norms).

    lams is (B, 2n) = [lambda_lb; lambda_ub] (both >= 0)."""
    n = x.shape[-1]
    lam_lb = lams[..., :n]
    lam_ub = lams[..., n:]
    stat = (Q @ x[..., None])[..., 0] + p - lam_lb + lam_ub
    if A is not None:
        stat = stat + (A.mT @ nus[..., None])[..., 0]
        eq = ((A @ x[..., None])[..., 0] - b).abs().amax(dim=-1)
    else:
        eq = x.new_zeros(x.shape[0])
    finite_lb = torch.isfinite(lb)
    finite_ub = torch.isfinite(ub)
    zero = x.new_zeros(())
    viol_lb = torch.where(finite_lb, torch.clamp(lb - x, min=0.0), zero)
    viol_ub = torch.where(finite_ub, torch.clamp(x - ub, min=0.0), zero)
    comp_lb = torch.where(finite_lb, (lam_lb * (x - lb)).abs(), zero)
    comp_ub = torch.where(finite_ub, (lam_ub * (ub - x)).abs(), zero)
    return {
        "stationarity": stat.abs().amax(dim=-1),
        "eq": eq,
        "bound_violation": torch.maximum(viol_lb, viol_ub).amax(dim=-1),
        "complementarity": torch.maximum(comp_lb, comp_ub).amax(dim=-1),
    }
