"""Single-problem NumPy box-QP ADMM solver (float64 CPU reference).

The port's own copy of ``lqp_py_tpu/cpu/boxqp_numpy.py``, so that the
port imports nothing of the JAX package; the two give the same output bit
for bit (tests/test_torch_cpu_oracles.py).

Component parity with the reference's non-batched scalar solver
(``solve_box_qp`` / ``BoxQP``, solve_box_qp_admm.py:7-282): same problem
class, Jacobi scaling with the quantile-blended beta, scalar auto/adaptive
rho with refactorization, and OSQP-style stopping on unscaled residuals —
a readable, dependency-free oracle that covers the tuned paths of the
batched solver (the fast path is the C++ core in native/lqp_native.cpp,
bound by ``cpu/native.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.linalg import lu_factor, lu_solve

_ZERO_CLAMP = 1e-16


def prep_bound(v, n_x: int, default: float):
    if v is None:
        return np.full(n_x, default)
    v = np.asarray(v, np.float64).reshape(-1)
    if v.size == 1:
        return np.full(n_x, float(v[0]))
    return v


def solve_box_qp_np(Q, p, A=None, b=None, lb=None, ub=None,
                    rho: Optional[float] = None, eps_abs: float = 1e-6,
                    eps_rel: float = 1e-6, max_iters: int = 100000,
                    check_every: Optional[int] = None,
                    scale: bool = True, beta: Optional[float] = None,
                    adaptive_rho: bool = True,
                    adaptive_rho_tol: float = 5.0,
                    adaptive_rho_iter: int = 25,
                    adaptive_rho_max_iter: int = 1000,
                    adaptive_rho_threshold: float = 1e-5):
    """Solve one box QP.  Returns dict {x, z, u, nus, lams, rho, iter,
    primal_error, dual_error, converged}.

    Scaling and adaptive rho mirror the reference scalar solver
    (solve_box_qp_admm.py:125-234); defaults follow this framework's tuned
    batched solver (scale + adaptive rho on, early first update).
    """
    Q = np.asarray(Q, np.float64)
    p = np.asarray(p, np.float64).reshape(-1)
    n = p.shape[0]
    lb = prep_bound(lb, n, -np.inf)
    ub = prep_bound(ub, n, np.inf)
    m = 0
    if A is not None:
        A = np.asarray(A, np.float64).reshape(-1, n)
        b = np.asarray(b, np.float64).reshape(-1)
        m = A.shape[0]

    any_ineq = np.max(lb) > -np.inf or np.min(ub) < np.inf
    # Dual-tolerance norm uses the UNSCALED p (as the batched solver does,
    # solve_box_qp_admm_torch.py:127).
    p_norm = np.max(np.abs(p)) if n else 0.0

    # --- scaling (solve_box_qp_admm.py:126-151): Jacobi D from Q column
    # inf-norms with the quantile-blended beta; row equilibration E of A.
    if scale:
        Q_norm = np.max(np.abs(Q), axis=0)
        if (Q_norm <= 0).any():
            fill = Q_norm[Q_norm > 0].mean() if (Q_norm > 0).any() else 1.0
            Q_norm = np.where(Q_norm <= 0, fill, Q_norm)
        D = np.sqrt(1.0 / Q_norm)
        if beta is None:
            q10, q90 = np.quantile(D, [0.10, 0.90])
            beta = 1.0 - q10 / q90 if q90 > 0 else 0.0
        D = (1.0 - beta) * D + beta * D.mean()
        Q = D[:, None] * Q * D
        p = D * p
        if m:
            A = A * D
            A_norm = np.max(np.abs(A), axis=1)
            if (A_norm <= 0).any():
                fillA = (A_norm[A_norm > 0].mean()
                         if (A_norm > 0).any() else 1.0)
                A_norm = np.where(A_norm <= 0, fillA, A_norm)
            E = 1.0 / A_norm
            A = E[:, None] * A
            b = E * b
        else:
            E = np.ones(0)
        if any_ineq:
            lb = lb / D
            ub = ub / D
    else:
        D = np.ones(n)
        E = np.ones(m)

    # --- rho selection on the scaled problem (solve_box_qp_admm.py:156-160).
    if rho is None:
        rho = float(np.linalg.norm(Q) / np.sqrt(n)) if any_ineq else 0.0
        rho = min(max(rho, 1e-6), 1e6)
    if not any_ineq:
        rho = 0.0
    if check_every is None:
        check_every = max(round(np.sqrt(n) / 10) * 10, 1)
    adaptive_rho_iter = max(round(adaptive_rho_iter / check_every)
                            * check_every, 1)

    Id = np.eye(n)

    def factorize(rho_):
        K = np.zeros((n + m, n + m))
        K[:n, :n] = Q + rho_ * Id
        if m:
            K[:n, n:] = A.T
            K[n:, :n] = A
        return lu_factor(K)

    factors = factorize(rho)

    x = np.zeros(n)
    z = np.zeros(n)
    u = np.zeros(n)
    nus = np.zeros(m)
    primal = dual = np.inf
    tolp_norm = told_norm = 1.0
    converged = False
    it = 0
    for it in range(max_iters):
        # --- adaptive rho (solve_box_qp_admm.py:189-203): every
        # adaptive_rho_iter iterations while errors are above threshold,
        # rho *= sqrt(primal_ratio / dual_ratio) with refactorization.
        if (adaptive_rho and it % adaptive_rho_iter == 0
                and 0 < it < adaptive_rho_max_iter
                and (primal > adaptive_rho_threshold
                     or dual > adaptive_rho_threshold)):
            num = max(primal / tolp_norm, _ZERO_CLAMP)
            den = max(dual / told_norm, _ZERO_CLAMP)
            ratio = np.sqrt(num / den)
            if ratio > adaptive_rho_tol or ratio < 1.0 / adaptive_rho_tol:
                rho = min(max(rho * ratio, 1e-6), 1e6)
                factors = factorize(rho)

        rhs = np.concatenate([-p + rho * (z - u), b]) if m \
            else (-p + rho * (z - u))
        sol = lu_solve(factors, rhs)
        x = sol[:n]
        if m:
            nus = sol[n:]
        z_prev = z
        z = np.clip(x + u, lb, ub)
        u = u + (x - z)
        if it % check_every == 0:
            # Unscaled residuals (solve_box_qp_admm.py:227-244).
            primal = np.max(np.abs(D * (x - z)))
            dual = rho * np.max(np.abs(D * (z - z_prev)))
            tolp_norm = max(np.max(np.abs(D * x)), np.max(np.abs(D * z)),
                            _ZERO_CLAMP)
            told_norm = max(rho * np.max(np.abs(D * u)),
                            np.max(np.abs(Q @ x / D)), p_norm, _ZERO_CLAMP)
            tol_p = eps_abs + eps_rel * tolp_norm
            tol_d = eps_abs + eps_rel * told_norm
            if primal < tol_p and dual < tol_d:
                converged = True
                it += 1
                break

    # --- unscale + dual extraction (solve_box_qp_admm.py:246-266).
    x_out = D * x
    z_out = D * z
    u_out = u / D
    lam = rho * u_out
    lams = np.concatenate([np.maximum(-lam, 0), np.maximum(lam, 0)])
    return {"x": x_out, "z": z_out, "u": u_out,
            "nus": nus * E if m else None, "lams": lams, "rho": rho,
            "iter": it, "primal_error": primal, "dual_error": dual,
            "converged": converged}


class BoxQPNumpy:
    """Stateful wrapper (``BoxQP`` analogue, solve_box_qp_admm.py:7-42)."""

    def __init__(self, Q, p, A=None, b=None, lb=None, ub=None, **options):
        self.Q, self.p, self.A, self.b = Q, p, A, b
        self.lb, self.ub = lb, ub
        self.options = options
        self.sol = None

    def solve(self):
        self.sol = solve_box_qp_np(self.Q, self.p, self.A, self.b,
                                   self.lb, self.ub, **self.options)
        return self.sol["x"]

    def update(self, Q=None, p=None, A=None, b=None, lb=None, ub=None,
               **options):
        if Q is not None:
            self.Q = Q
        if p is not None:
            self.p = p
        if A is not None:
            self.A = A
        if b is not None:
            self.b = b
        if lb is not None:
            self.lb = lb
        if ub is not None:
            self.ub = ub
        self.options.update(options)
