"""Implicit backward passes for the box-QP layer (counterpart of
``lqp_py_tpu.models.box_qp_grad``).

- ``fixed_point``: implicit differentiation of the ADMM fixed-point map,
  one batched solve of a masked reduced KKT system.
- ``kkt``: implicit differentiation of the KKT conditions with the box
  written as ``G = [-I; I], h = [-lb; ub]``, condensed to an n x n solve.

Both take the residual set the layer saves (unscaled, (B, n) / (B, m)
layout) and return ``(dQ, dp, dA, db, dlb, dub)``.  ``want_dQ`` /
``want_dA`` (and ``qp_int_grads``'s ``want_dG``) = False return None in
place of the (B, n, n), (B, m, n) (and (B, k, n)) outer products: the
JAX package builds them and leaves XLA to drop the dead ones, eager
PyTorch would build them all.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops.kernels.spd_inverse import LEAF
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.utils.profiling import span


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _sym_outer(a, b):
    """``0.5 (a b^T + b a^T)``: the gradient of a symmetric-use Q."""
    half = 0.5 * _outer(a, b)
    return half + half.mT


def reduced_kkt_solve(H, A, r, reg, equilibrate: bool = True):
    """Solve ``[[H, A^T], [A, 0]] [dv; dnu] = [r; 0]`` for SPD H through
    ``spd_solve_fast`` (one solve for r and A^T together) and an m x m
    Schur complement.  ``A`` may be None (returns dnu=None).

    ``equilibrate=False``: the caller pre-scaled the system to unit
    diagonal (dv = D w with As = A D, rs = D r); the returned ``w`` must be
    unscaled by the caller, ``dnu`` is invariant.  One ``lqp.factorize``
    span: the backward's factorization."""
    with span("lqp.factorize"):
        if A is None:
            return lin.spd_solve_fast(H, r[..., None],
                                      equilibrate=equilibrate)[..., 0], None
        m = A.shape[-2]
        R = torch.cat([r[..., None], A.mT], dim=-1)
        X = lin.spd_solve_fast(H, R, equilibrate=equilibrate)  # (B, n, 1+m)
        x0 = X[..., 0]
        W = X[..., 1:]                                      # H^-1 A^T
        S = A @ W + reg * torch.eye(m, dtype=r.dtype, device=r.device)
        Sinv = lin.spd_inverse(S)                           # m x m: tiny
        dnu = lin._mv(Sinv, lin._mv(A, x0))
        return x0 - lin._mv(W, dnu), dnu


@solver_precision
def box_qp_grad_fixed_point(dl_dz, x, u, lams, nus, Q, A, lb, ub, rho,
                            reg: float = 1e-8, want_dQ: bool = True,
                            want_dA: bool = True):
    """Fixed-point implicit VJP.  ``rho`` is (B,).

    The row-masked system ``[[dpi*Q + diag(rho (1-dpi)), dpi*A^T], [A, 0]]``
    forces ``dv_i = 0`` on clamped coordinates, so it is solved as the
    row-and-column masked symmetric system
    ``[[dpi Q dpi + diag(rho (1-dpi)), dpi A^T], [A dpi, 0]]``, built
    Jacobi-equilibrated in one pass.  For float32 the system is built at
    the next multiple of 128 with an inert identity pad (the JAX package
    does so on a TPU only): the port's float32 solve always takes the
    recursion.

    Returns (dQ, dp, dA, db, dlb, dub); dA/db are None when A is None."""
    n = x.shape[-1]
    dtype = x.dtype
    rho_col = rho[..., None]

    # Projection derivative: 0 where x + u violates a bound, 1 inside.
    s_xu = x + u
    dpi = (~((s_xu > ub) | (s_xu < lb))).to(dtype)
    dl_dx = dl_dz * dpi

    # diag of the masked system, and s = diag^-1/2 for the change of
    # variables dv = s w, A_s = A diag(dpi s), r_s = s r (dnu invariant).
    diag_q = Q.diagonal(dim1=-2, dim2=-1)
    diag_h = dpi * dpi * diag_q + rho_col * (1.0 - dpi) + reg
    s_eq = torch.rsqrt(torch.clamp(diag_h, min=1e-30))
    m_eq = dpi * s_eq

    pad = -(-n // LEAF) * LEAF - n if dtype == torch.float32 else 0
    rhs_b = -s_eq * dl_dx
    Qb, m_b, dq_b, A_b = Q, m_eq, diag_q, A
    if pad:
        # Padded coordinates get m = 0 and diagonal 1: a decoupled
        # identity block, as in the forward solver.
        Qb = F.pad(Q, (0, pad, 0, pad))
        m_b, dq_b, rhs_b = (F.pad(v, (0, pad)) for v in (m_eq, diag_q,
                                                          rhs_b))
        A_b = None if A is None else F.pad(A, (0, pad))
    Hs = m_b[..., :, None] * Qb * m_b[..., None, :]
    Hs.diagonal(dim1=-2, dim2=-1).add_(1.0 - m_b * m_b * dq_b)
    A_s = None if A_b is None else A_b * m_b[..., None, :]

    w, dnu = reduced_kkt_solve(Hs, A_s, rhs_b, reg, equilibrate=False)
    dv = s_eq * w[..., :n]

    dl_dp = dv
    dl_dQ = _sym_outer(dv, x) if want_dQ else None
    dl_dA = dl_db = None
    if A is not None:
        dl_db = -dnu
        if want_dA:
            dl_dA = _outer(dnu, x) + _outer(nus, dv)

    # Bound gradients through the stationarity residual.
    kkt = -dl_dz - lin._mv(Q, dv)
    if A is not None:
        kkt = kkt - lin._mv(A.mT, dnu)
    div = rho_col * u
    div = torch.where(div == 0, torch.ones_like(div), div)
    dlam = kkt / div
    dl_dlb = dlam * lams[..., :n]
    dl_dub = -dlam * lams[..., n:]
    return dl_dQ, dl_dp, dl_dA, dl_db, dl_dlb, dl_dub


def make_kkt_jacobian(Q, G, A, lams, slacks):
    """Full (non-symmetric) KKT Jacobian
    ``[[Q, G^T diag(lam), A^T], [G, -diag(s), 0], [A, 0, 0]]``.
    G/A may be None."""
    B = Q.shape[0]
    kw = dict(dtype=Q.dtype, device=Q.device)
    n_ineq = 0 if G is None else G.shape[-2]
    n_eq = 0 if A is None else A.shape[-2]
    row1 = [Q]
    if G is not None:
        row1.append(G.mT * lams[..., None, :])
    if A is not None:
        row1.append(A.mT)
    rows = [torch.cat(row1, dim=-1)]
    if G is not None:
        row2 = [G, -torch.diag_embed(slacks)]
        if A is not None:
            row2.append(torch.zeros((B, n_ineq, n_eq), **kw))
        rows.append(torch.cat(row2, dim=-1))
    if A is not None:
        row3 = [A]
        if G is not None:
            row3.append(torch.zeros((B, n_eq, n_ineq), **kw))
        row3.append(torch.zeros((B, n_eq, n_eq), **kw))
        rows.append(torch.cat(row3, dim=-1))
    return torch.cat(rows, dim=-2)


def solve_kkt_backwards(dl_dz, sol_mat, n_eq, n_ineq):
    """Solve the KKT Jacobian system for the differentials
    ``(dx, dlam, dnu)`` (dlam / dnu None when there are no such rows)."""
    B, n = dl_dz.shape
    rhs = torch.cat([-dl_dz, dl_dz.new_zeros((B, n_eq + n_ineq))], dim=-1)
    d = torch.linalg.solve(sol_mat, rhs[..., None])[..., 0]
    dx = d[..., :n]
    dlam = d[..., n:n + n_ineq] if n_ineq > 0 else None
    dnu = d[..., n + n_ineq:] if n_eq > 0 else None
    return dx, dlam, dnu


def qp_int_grads(x, lams, nus, dx, dlam, dnu, want_dQ: bool = True,
                 want_dA: bool = True, want_dG: bool = True) -> Tuple:
    """OptNet-style gradient assembly from the differentials:
    (dQ, dp, dA, db, dG, dh)."""
    dl_dQ = _sym_outer(dx, x) if want_dQ else None
    dl_dG = dl_dh = None
    if dlam is not None:
        if want_dG:
            dl_dG = lams[..., :, None] * _outer(dlam, x) + _outer(lams, dx)
        dl_dh = -lams * dlam
    dl_dA = dl_db = None
    if dnu is not None:
        if want_dA:
            dl_dA = _outer(dnu, x) + _outer(nus, dx)
        dl_db = -dnu
    return dl_dQ, dx, dl_dA, dl_db, dl_dG, dl_dh


@solver_precision
def box_qp_grad_kkt(dl_dz, x, lams, nus, Q, A, lb, ub,
                    slack_clamp: float = 1e-8, slack_max: float = 1e12,
                    want_dQ: bool = True, want_dA: bool = True):
    """KKT implicit VJP with the box as ``G = [-I; I]``.  Slacks
    ``[x - lb; ub - x]`` are clamped to ``[slack_clamp, slack_max]`` (an
    infinite bound gives a finite slack, a vanishing multiplier and a zero
    bound gradient) and the multipliers from below at ``slack_clamp``.

    The complementarity rows are eliminated analytically
    (``dlam = (G dx) / s``), which condenses the (3n+m)-square Jacobian to
    ``Q + diag(lam_lb/s_lb + lam_ub/s_ub)`` and the equality rows."""
    n = x.shape[-1]
    slacks = torch.clamp(torch.cat([x - lb, ub - x], dim=-1), slack_clamp,
                         slack_max)
    lams_c = torch.clamp(lams, min=slack_clamp)
    w = lams_c / slacks                                   # (B, 2n)
    H = Q.clone()
    H.diagonal(dim1=-2, dim2=-1).add_(w[..., :n] + w[..., n:])
    dx, dnu = reduced_kkt_solve(H, A, -dl_dz, reg=0.0)
    dlam = torch.cat([-dx, dx], dim=-1) / slacks          # (G dx) / s
    dl_dQ, dl_dp, dl_dA, dl_db, _dl_dG, dl_dh = qp_int_grads(
        x, lams_c, nus, dx, dlam, dnu, want_dQ=want_dQ, want_dA=want_dA)
    return dl_dQ, dl_dp, dl_dA, dl_db, -dl_dh[..., :n], dl_dh[..., n:]
