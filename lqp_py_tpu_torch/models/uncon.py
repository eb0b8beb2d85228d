"""Unconstrained QP: ``x* = argmin 0.5 x'Qx + p'x = -Q^-1 p`` (counterpart
of ``lqp_py_tpu.models.uncon``), solved by a batched Cholesky factorization
(Q is SPD), with the implicit gradient as an autograd Function.
"""

from __future__ import annotations

import torch

from lqp_py_tpu_torch.ops.linalg import chol_solve, cholesky
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import EqQPSolution, as_vector, like_layout


def _factor(Q):
    Q = torch.as_tensor(Q)
    return cholesky(0.5 * (Q + Q.mT))   # symmetric-manifold


@solver_precision
def solve_qp_uncon(Q, p) -> EqQPSolution:
    """Non-differentiable solve.  p: (B, n) or (B, n, 1); x is (B, n)."""
    pv = as_vector(p, "p")
    return EqQPSolution(x=chol_solve(_factor(Q), -pv), nus=None)


class _QPUncon(torch.autograd.Function):

    @staticmethod
    @solver_precision
    def forward(ctx, Q, p):
        L = _factor(Q)
        x = chol_solve(L, -as_vector(p, "p"))
        ctx.save_for_backward(L, x)
        ctx.p3 = p.ndim == 3
        return like_layout(x, p)

    @staticmethod
    @solver_precision
    def backward(ctx, g):
        L, x = ctx.saved_tensors
        dl_dz = g[..., 0] if ctx.p3 else g
        dx = chol_solve(L, -dl_dz)          # Q^-1 (-dl/dx)
        dQ = 0.5 * (dx[..., :, None] * x[..., None, :]
                    + x[..., :, None] * dx[..., None, :])
        return dQ, (dx[..., None] if ctx.p3 else dx)


def qp_uncon(Q, p):
    """Differentiable unconstrained QP solve returning x in p's layout."""
    return _QPUncon.apply(torch.as_tensor(Q), torch.as_tensor(p))
