"""Equality-constrained QP: ``min 0.5 x'Qx + p'x  s.t. Ax = b`` by a direct
KKT solve (counterpart of ``lqp_py_tpu.models.eqcon``).

The solve goes through the Schur-complement Cholesky factorization of
``ops/linalg.py`` (``factorize_kkt(Q, 0, A, mode="cholesky")``), and the
backward re-solves the same factored system.  With ``A=None`` both entry
points fall back to the unconstrained solver.
"""

from __future__ import annotations

import torch

from lqp_py_tpu_torch.models.uncon import qp_uncon, solve_qp_uncon
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import EqQPSolution, as_vector, like_layout


def _factor_solve(Q, p, A, b):
    Q = torch.as_tensor(Q)
    Q = 0.5 * (Q + Q.mT)                         # symmetric-manifold input
    f = lin.factorize_kkt(Q, 0.0, torch.as_tensor(A), mode="cholesky")
    x, nus = lin.kkt_apply(f, -as_vector(p, "p"), as_vector(b, "b"))
    return f, x, nus


@solver_precision
def solve_qp_eqcon(Q, p, A=None, b=None) -> EqQPSolution:
    """Non-differentiable solve; x is (B, n), nus (B, m)."""
    if A is None:
        return solve_qp_uncon(Q, p)
    _f, x, nus = _factor_solve(Q, p, A, b)
    return EqQPSolution(x=x, nus=nus)


@solver_precision
def _fwd(Q, p, A, b):
    """The forward of ``qp_eqcon``: x in p's layout and the residuals of
    the backward (the factors, x and nu)."""
    if A is None:
        raise ValueError("qp_eqcon requires A; use qp_uncon for A=None")
    f, x, nus = _factor_solve(Q, p, A, b)
    return like_layout(x, p), (f, x, nus)


@solver_precision
def _bwd(res, g, p3, b3):
    f, x, nus = res
    dl_dz = g[..., 0] if p3 else g
    # Re-solve the same KKT system with rhs (-dl/dx, 0).
    dx, dnu = lin.kkt_apply(f, -dl_dz, torch.zeros_like(nus))
    dQ = 0.5 * (dx[..., :, None] * x[..., None, :]
                + x[..., :, None] * dx[..., None, :])
    dA = dnu[..., :, None] * x[..., None, :] + nus[..., :, None] * dx[
        ..., None, :]
    db = -dnu
    return (dQ, dx[..., None] if p3 else dx, dA,
            db[..., None] if b3 else db)


class _QPEqcon(torch.autograd.Function):

    @staticmethod
    def forward(ctx, Q, p, A, b):
        out, (f, x, nus) = _fwd(Q, p, A, b)
        ctx.factors = f
        ctx.save_for_backward(x, nus)
        ctx.layouts = (p.ndim == 3, b.ndim == 3)
        return out

    @staticmethod
    def backward(ctx, g):
        x, nus = ctx.saved_tensors
        return _bwd((ctx.factors, x, nus), g, *ctx.layouts)


def qp_eqcon(Q, p, A, b):
    """Differentiable equality-constrained QP solve returning x in p's
    layout (``qp_uncon`` when A is None)."""
    if A is None:
        return qp_uncon(Q, p)
    return _QPEqcon.apply(*(torch.as_tensor(t) for t in (Q, p, A, b)))
