"""Batched primal-dual interior-point QP solver (counterpart of
``lqp_py_tpu.models.optnet``):

    x* = argmin_x 0.5 x'Qx + p'x   s.t.  Ax = b,  Gx <= h

Mehrotra predictor-corrector steps with 0.999 ratio-test step lengths, a
per-element relative stopping test, a two-round active-set polish (a third
where needed) and the KKT implicit backward that reuses the forward's
factors.  Every fixed operator is a materialized inverse
(``spd_inverse_fast``: SWEEP leaves in float32), so each KKT solve is a
handful of batched GEMVs.  Two
factorizations, chosen by constraint count (``OptNetConfig.factor``):

- 'schur': precompute Q^-1 and the inequality-Schur blocks; per iteration
  invert the ni x ni ``G Q^-1 G^T - T (G Q^-1 A^T)^T + diag(1/d)``;
- 'condensed': eliminate (ds, dz) and per iteration invert the n x n
  ``Q + G^T diag(d) G`` (the box G = [-I; I] has ni = 2n).

The JAX package's ``lax.while_loop`` is a host loop with one device read
per iteration.  Converged elements are frozen (step length 0), and the
loop runs as many iterations as the JAX package's.

Spans (``utils/profiling.span``): ``lqp.factorize`` inside each
factorizing function (``ip_pre_factor``, ``ip_factor_L22``,
``ip_factor_condensed``, the polish's), so one per factorization wherever
it is called, the backward's included; ``lqp.loop`` around the iterations,
``lqp.check`` around each iteration's host read, ``lqp.polish`` around the
polish.

The polish (``_polish.polish_rounds``) departs from the JAX package's in
three ways.  Its acceptance reads the equality residual beyond its rounding
(``_polish.equality_excess``), where the JAX package reads it whole and, in
float32 at n=1000, rejects correct polishes.  Where round 2 narrowly fails
on an element, a third round on those elements alone repairs the guess
once more.  And the layer's backward differentiates the polished point:
it takes the accepted round's multipliers, 0 on the rows left free, where
the JAX package's takes the IP's z, whose z/s is of order one on free
coordinates near a bound at a loose tolerance (the solution's ``lams``
stay the IP's z, as the JAX package's).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from lqp_py_tpu_torch.config import OptNetConfig
from lqp_py_tpu_torch.models._polish import (GenPolishResult,
                                             acceptance_threshold, accepted,
                                             equality_excess,
                                             gen_lam_threshold,
                                             gen_penalty_polish,
                                             polish_rounds)
from lqp_py_tpu_torch.models.box_qp_grad import _outer, _sym_outer
from lqp_py_tpu_torch.models.eqcon import qp_eqcon, solve_qp_eqcon
from lqp_py_tpu_torch.ops import collective
from lqp_py_tpu_torch.ops.linalg import _mv, spd_inverse_fast
from lqp_py_tpu_torch.ops.operator import DENSE
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import QPSolution, as_vector, like_layout
from lqp_py_tpu_torch.utils.profiling import span


def _mtv(M, v):
    return _mv(M.mT, v)


def _inf_norm(v):
    return v.abs().amax(dim=-1)


def _d_cap(dtype) -> float:
    # Near convergence z/s spans ~1/tol^2, which overflows a float32
    # factorization; the clamp only saturates directions resolved far
    # beyond the stopping tolerance.
    return 1e8 if dtype == torch.float32 else 1e16


class IPFactors(NamedTuple):
    """Cached d-independent pieces of the Schur-mode KKT operator:

      S = [[S11, S12], [S21, S22(d)]],  S11 = A Q^-1 A^T,
      S21 = G Q^-1 A^T,  S22 = G Q^-1 G^T + diag(1/d)
      Rt  = G Q^-1 G^T - S21 S11^-1 S12
    """
    Qinv: torch.Tensor              # Q^-1
    S11inv: Optional[torch.Tensor]  # (A Q^-1 A^T)^-1, None without A
    T: Optional[torch.Tensor]       # S21 S11^-1
    Rt: torch.Tensor


def ip_pre_factor(Q, A, G, ops=DENSE) -> IPFactors:
    """The d-independent pieces.  Only ``Qinv`` has n columns (held as
    ``ops`` holds Q); the rest is whole.  One ``lqp.factorize`` span: the
    m x m inverse of the equality rows' Schur complement goes with Q's."""
    with span("lqp.factorize"):
        Qinv = ops.inverse(Q)
        R = ops.mm(G, ops.mmt(Qinv, G))                   # (B, ni, ni)
        if A is None:
            return IPFactors(Qinv=Qinv, S11inv=None, T=None, Rt=R)
        invQ_At = ops.mmt(Qinv, A)                        # (B, n, m)
        S11inv = spd_inverse_fast(ops.mm(A, invQ_At))
        GQA = ops.mm(G, invQ_At)                          # (B, ni, m)
        T = GQA @ S11inv
        return IPFactors(Qinv=Qinv, S11inv=S11inv, T=T, Rt=R - T @ GQA.mT)


def ip_factor_L22(f: IPFactors, d, int_reg):
    """The d-dependent refactorization: the inverse of
    ``Rt + diag(1/d) + int_reg I``, applied as a GEMV."""
    with span("lqp.factorize"):
        M = f.Rt.clone()
        M.diagonal(dim1=-2, dim2=-1).add_(1.0 / d).add_(int_reg)
        return spd_inverse_fast(M)


def _schur_solve(f: IPFactors, Minv, H_eq, H_in):
    """Solve S w = [H_eq; H_in] through the cached inverses."""
    if f.S11inv is None:
        return None, _mv(Minv, H_in)
    w_in = _mv(Minv, H_in - _mv(f.T, H_eq))
    return _mv(f.S11inv, H_eq) - _mtv(f.T, w_in), w_in


def ip_solve_kkt(f: IPFactors, Minv, d, G, A, rx, rs, rz, ry, ops=DENSE):
    """One KKT solve of the interior-point system in Schur mode."""
    invQ_rx = ops.mv(f.Qinv, rx)
    H_in = ops.mv(G, invQ_rx) + rs / d - rz
    H_eq = None if A is None else ops.mv(A, invQ_rx) - ry
    w_eq, w_in = _schur_solve(f, Minv, H_eq, H_in)
    dz = -w_in
    dy = None if w_eq is None else -w_eq
    g1 = -rx - ops.mtv(G, dz)
    if A is not None:
        g1 = g1 - ops.mtv(A, dy)
    return ops.mv(f.Qinv, g1), (-rs - dz) / d, dz, dy


class CondensedFactors(NamedTuple):
    """``Hinv = (Q + G^T diag(d) G + int_reg I)^-1``; ``W = Hinv A^T`` and
    ``Sinv = (A W + int_reg I)^-1`` are None without equality
    constraints."""
    Hinv: torch.Tensor
    W: Optional[torch.Tensor]
    Sinv: Optional[torch.Tensor]


def ip_factor_condensed(Q, A, G, d, int_reg,
                        ops=DENSE) -> CondensedFactors:
    """Per-iteration factorization of ``H(d) = Q + G^T diag(d) G``; d > 0
    keeps H SPD."""
    with span("lqp.factorize"):
        Hinv = ops.inverse(ops.add_diag(
            Q + ops.gram(G, d[..., :, None] * G), int_reg))
        if A is None:
            return CondensedFactors(Hinv=Hinv, W=None, Sinv=None)
        return CondensedFactors(Hinv, *ops.schur(Hinv, A, int_reg))


def ip_solve_condensed(fc: CondensedFactors, d, G, A, rx, rs, rz, ry,
                       Hmv=None, refine: int = 0, ops=DENSE):
    """Solve the Newton system

        Q dx + G^T dz + A^T dy = -rx,   A dx = -ry,
        G dx + ds = -rz,                d ds + dz = -rs

    through the condensed factors: eliminating dz and ds gives
    ``H(d) dx + A^T dy = -rx + G^T (rs - d rz)``.  ``refine`` > 0 applies
    that many iterative-refinement steps ``dx += Hinv (rhs - H dx)`` with
    the residual from the matrix-free product ``Hmv``."""
    rhs1 = -rx + ops.mtv(G, rs - d * rz)
    t = ops.mv(fc.Hinv, rhs1)
    if A is None:
        dx, dy, rhs_eff = t, None, rhs1
    else:
        dy = _mv(fc.Sinv, ops.mv(A, t) + ry)
        dx = t - _mv(fc.W, dy)
        rhs_eff = rhs1 - ops.mtv(A, dy)
    for _ in range(refine):
        dx = dx + ops.mv(fc.Hinv, rhs_eff - Hmv(dx))
    ds = -rz - ops.mv(G, dx)
    return dx, ds, -rs - d * ds, dy


def _use_condensed(config, n, ni) -> bool:
    factor = config.factor
    if factor == "auto":
        # Condensed costs ~2n^3 + 2n^2 ni per iteration, Schur ~2ni^3.
        return ni > n
    if factor not in ("condensed", "schur"):
        raise ValueError(f"unknown factor mode {factor!r}")
    return factor == "condensed"


def _ratio_step(v, dv):
    """Largest step with ``v + alpha dv >= 0``: min over the positive
    entries of -v/dv (inf where there are none)."""
    a = -v / dv
    return torch.where(a > 0, a, torch.inf).amin(dim=-1)


def _step_length(pairs):
    """0.999 times the largest step in [0, 1] keeping every ``v + alpha
    dv`` of ``pairs`` nonnegative, per element, as (B, 1)."""
    alpha = functools.reduce(torch.minimum,
                             (_ratio_step(v, dv) for v, dv in pairs))
    return (0.999 * torch.clamp(alpha, max=1.0))[..., None]


def _condensed_solver(Q, A, G, d, int_reg, refine, ops=DENSE):
    fc = ip_factor_condensed(Q, A, G, d, int_reg, ops)

    def Hmv(v):
        return ops.mv(Q, v) + ops.mtv(G, d * ops.mv(G, v)) + int_reg * v

    return functools.partial(ip_solve_condensed, fc, d, G, A, Hmv=Hmv,
                             refine=refine, ops=ops)


class _IPState(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    y: Optional[torch.Tensor]
    error: torch.Tensor          # () batch-reduced residual ('mean' exit)
    primal: torch.Tensor         # (B,)
    dual: torch.Tensor           # (B,)
    converged: torch.Tensor      # (B,) bool
    busy: Optional[torch.Tensor] = None   # () some element unconverged
    #                                       ('amax' exit)


def solve_qp_optnet(Q, p, A=None, b=None, G=None, h=None,
                    config: OptNetConfig = OptNetConfig()) -> QPSolution:
    """Forward interior-point solve.  Returns a QPSolution; with G None it
    is the direct equality-constrained solve."""
    return _solve_qp_optnet_full(Q, p, A, b, G, h, config)[0]


def _solve_qp_optnet_full(Q, p, A, b, G, h, config, ops=DENSE):
    """The solve and, in Schur mode, its ``IPFactors`` (else None).  Q, A
    and G as ``ops`` holds them (``ops/operator.py``)."""
    return _solve_ip(Q, p, A, b, G, h, config, ops)[:2]


@solver_precision
def _solve_ip(Q, p, A, b, G, h, config, ops=DENSE):
    """``_solve_qp_optnet_full``'s solve, factors and, third, the
    multipliers the layer's backward differentiates with: where a polish
    round was accepted, its AL multipliers, which are 0 on the rows it left
    free (the solution's ``lams`` keep the IP's z, as the JAX package's
    do); elsewhere the IP's z.  Both clamped to 1e-8."""
    Q = torch.as_tensor(Q)
    if config.symmetrize:
        Q = ops.symmetrize(Q)
    dtype = Q.dtype
    p = as_vector(p, "p").to(dtype)
    B, n = p.shape
    kw = dict(dtype=dtype, device=p.device)

    if G is None:
        eq = solve_qp_eqcon(Q, p, A, b)
        return QPSolution(
            x=eq.x, lams=torch.zeros((B, 0), **kw),
            slacks=torch.zeros((B, 0), **kw), nus=eq.nus, iterations=0,
            primal_residual=torch.zeros((B,), **kw),
            dual_residual=torch.zeros((B,), **kw),
            converged=torch.ones((B,), dtype=torch.bool,
                                 device=p.device)), None, None

    G = torch.as_tensor(G).to(dtype)
    h = as_vector(h, "h").to(dtype)
    A = None if A is None else torch.as_tensor(A).to(dtype)
    b = None if b is None else as_vector(b, "b").to(dtype)
    ni = G.shape[-2]
    int_reg = float(config.int_reg)
    tol = float(config.tol)

    if _use_condensed(config, n, ni):
        f = None

        def make_solver(d):
            return _condensed_solver(Q, A, G, d, int_reg,
                                     int(config.refine_steps), ops)
    else:
        f = ip_pre_factor(Q, A, G, ops)

        def make_solver(d):
            return functools.partial(ip_solve_kkt, f,
                                     ip_factor_L22(f, d, int_reg), d, G, A,
                                     ops=ops)

    # Init: one KKT solve at d = 1, then s and z shifted to >= 1.
    x0, s0, z0, y0 = make_solver(torch.ones((B, ni), **kw))(
        rx=p, rs=torch.zeros((B, ni), **kw), rz=-h,
        ry=None if b is None else -b)
    s0 = s0 + torch.clamp(1.0 - s0.amin(dim=-1), min=0.0)[..., None]
    z0 = z0 + torch.clamp(1.0 - z0.amin(dim=-1), min=0.0)[..., None]
    inf_b = torch.full((B,), torch.inf, **kw)
    st = _IPState(x=x0, s=s0, z=z0, y=y0,
                  error=torch.tensor(torch.inf, **kw), primal=inf_b,
                  dual=inf_b, converged=torch.zeros((B,), dtype=torch.bool,
                                                    device=p.device))

    p_norm, h_norm = _inf_norm(p), _inf_norm(h)
    b_norm = None if b is None else _inf_norm(b)
    eps_abs = eps_rel = tol
    d_cap = _d_cap(dtype)

    def body(st: _IPState, it: int) -> _IPState:
        Qx = ops.mv(Q, st.x)
        Gtz = ops.mtv(G, st.z)
        rx = Qx + Gtz + p
        ry = Aty = None
        if A is not None:
            Aty = ops.mtv(A, st.y)
            rx = rx + Aty
            ry = ops.mv(A, st.x) - b
        Gx = ops.mv(G, st.x)
        rz = Gx + st.s - h
        rs = st.z

        # Per-element relative stopping test (the framework's tol
        # semantics), with complementarity by the worst product relative
        # to the dual magnitude.
        mu = (st.s * st.z).sum(dim=-1) / ni
        prim = _inf_norm(rz)
        tolp_norm = torch.maximum(torch.maximum(_inf_norm(Gx),
                                                _inf_norm(st.s)), h_norm)
        if ry is not None:
            prim = torch.maximum(prim, _inf_norm(ry))
            tolp_norm = torch.maximum(
                tolp_norm, torch.maximum(_inf_norm(ry + b), b_norm))
        dual = _inf_norm(rx)
        told_norm = torch.maximum(torch.maximum(_inf_norm(Qx),
                                                _inf_norm(Gtz)), p_norm)
        if Aty is not None:
            told_norm = torch.maximum(told_norm, _inf_norm(Aty))
        comp = (st.s * st.z).amax(dim=-1)
        conv_el = ((prim < eps_abs + eps_rel * tolp_norm)
                   & (dual < eps_abs + eps_rel * told_norm)
                   & (comp < eps_abs + eps_rel * _inf_norm(st.z)))
        resid = (prim + dual) / 2.0 + mu

        d = torch.clamp(st.z / st.s, 1.0 / d_cap, d_cap)
        solve = make_solver(d)

        # Affine (predictor) step.
        dx_a, ds_a, dz_a, dy_a = solve(rx, rs, rz, ry)
        alpha = _step_length(((st.z, dz_a), (st.s, ds_a)))
        sig = (((st.s + alpha * ds_a) * (st.z + alpha * dz_a)).sum(dim=-1)
               / (st.s * st.z).sum(dim=-1)) ** 3

        # Centering-corrector step.
        rs_cor = ((-mu * sig)[..., None] + ds_a * dz_a) / st.s
        dx_c, ds_c, dz_c, dy_c = solve(
            torch.zeros_like(rx), rs_cor, torch.zeros_like(rz),
            None if ry is None else torch.zeros_like(ry))

        dx, ds, dz = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c
        alpha = torch.where(conv_el[..., None], 0.0,
                            _step_length(((st.z, dz), (st.s, ds))))

        # Batch-wide over the batch group (ops/collective.py): one
        # collective per iteration carries what the exit test reads.
        busy = None
        if config.reduce == "mean":
            error = collective.batch_mean(resid)
        else:
            red = collective.batch_max(torch.stack(
                [resid.amax(), (~conv_el).any().to(resid.dtype)]))
            error, busy = red[0], red[1] > 0
        if config.verbose:
            print(f"ip iter={it} gap={float(error):.3e}")
        return _IPState(
            x=st.x + alpha * dx, s=st.s + alpha * ds, z=st.z + alpha * dz,
            y=None if st.y is None else st.y + alpha * (dy_a + dy_c),
            error=error, primal=prim, dual=dual, converged=conv_el,
            busy=busy)

    it = 0
    with span("lqp.loop"):
        while it < config.max_iters:
            st = body(st, it)
            it += 1
            with span("lqp.check"):
                live = (float(st.error) >= tol if config.reduce == "mean"
                        else bool(st.busy))
            if not live:
                break

    fin = GenPolishResult(x=st.x, y=st.y, lam=st.z)
    if config.polish:
        with span("lqp.polish"):
            fin = _polish(Q, p, A, b, G, h, st, tol, h_norm, dtype, ops)

    sol = QPSolution(
        x=fin.x, lams=torch.clamp(st.z, min=1e-8),
        slacks=torch.clamp(h - ops.mv(G, fin.x), min=1e-8), nus=fin.y,
        iterations=it, primal_residual=st.primal, dual_residual=st.dual,
        converged=st.converged)
    return sol, f, torch.clamp(fin.lam, min=1e-8)


def _polish(Q, p, A, b, G, h, st: _IPState, tol, h_norm, dtype,
            ops) -> GenPolishResult:
    """The active-set polish of the last iterate
    (``_polish.polish_rounds``): per element the accepted round's x, y and
    AL multipliers, or the IP's x, y and z where no round passes."""
    def _viol(xv, k):
        # The refinement residual is built from H = Q + G'WG only, so the
        # equality residual is part of the acceptance test; it is read
        # beyond its rounding (``equality_excess``).  ``k``: the elements
        # xv belongs to.
        v = torch.clamp(ops.mv(G[k], xv) - h[k], min=0.0).amax(dim=-1)
        if A is not None:
            v = torch.maximum(v, equality_excess(A[k], b[k], xv, ops))
        return v

    thr_acc = acceptance_threshold(tol, h_norm)
    # Multipliers are held to the AL accumulation's w*eps noise floor.
    thr_lam = gen_lam_threshold(thr_acc, dtype)
    viol_ip = _viol(st.x, slice(None))
    # Classify against slacks recomputed from x (h - Gx), not the IP's
    # slack variables, which drift by the primal residual.
    act = st.z > (h - ops.mv(G, st.x))

    def solve(a, k):
        return gen_penalty_polish(
            Q[k], p[k], None if A is None else A[k],
            None if b is None else b[k], G[k], h[k], act=a[k], ops=ops)

    def repair(a, pr):
        # Release rows whose AL multiplier came back negative, pin rows
        # the point violates.
        return ((a & (pr.lam >= -thr_lam[..., None]))
                | ((ops.mv(G, pr.x) - h) > thr_acc[..., None]))

    def ok(pr, k, within):
        return accepted(_viol(pr.x, k), viol_ip[k], thr_acc[k],
                        pr.lam.amin(dim=-1), thr_lam[k], within)

    return polish_rounds(solve, repair, ok, act,
                         GenPolishResult(x=st.x, y=st.y, lam=st.z))


@solver_precision
def optnet_grads(dl_dz, x, lams, slacks, nus, Q, A, G,
                 f: Optional[IPFactors], int_reg: float, refine: int = 0,
                 want_dQ: bool = True, want_dA: bool = True,
                 want_dG: bool = True):
    """KKT backward reusing the forward's factors:
    (dQ, dp, dA, db, dG, dh).  ``f`` is None in condensed mode (the n x n
    factor is rebuilt from (lams, slacks)).  ``want_*`` = False returns None
    in place of the (B, n, n), (B, m, n) and (B, ni, n) outer products;
    dA and db are None without A."""
    B, ni = x.shape[0], G.shape[-2]
    # The forward's clamp: a multiplier underflowing to 0 would make 1/d
    # infinite in Schur mode and the gradients NaN.
    d_cap = _d_cap(x.dtype)
    d = torch.clamp(lams / slacks, 1.0 / d_cap, d_cap)
    if f is None:
        solve = _condensed_solver(Q, A, G, d, int_reg, refine)
    else:
        solve = functools.partial(ip_solve_kkt, f,
                                  ip_factor_L22(f, d, int_reg), d, G, A)
    zero_in = x.new_zeros((B, ni))
    ry = None if A is None else x.new_zeros((B, A.shape[-2]))
    dx, _ds, dlam_t, dnu = solve(rx=dl_dz, rs=zero_in, rz=zero_in, ry=ry)
    # The solve's dz is D(lams) dlam (Amos & Kolter, eq. 8).
    dlam = dlam_t / lams
    dl_dQ = _sym_outer(dx, x) if want_dQ else None
    dl_dG = (lams[..., :, None] * _outer(dlam, x) + _outer(lams, dx)
             if want_dG else None)
    dl_dA = dl_db = None
    if A is not None:
        if want_dA:
            dl_dA = _outer(dnu, x) + _outer(nus, dx)
        dl_db = -dnu
    return dl_dQ, dx, dl_dA, dl_db, dl_dG, -lams * dlam


class _OptNetFunction(torch.autograd.Function):
    """Canonical-layout ((B, n)) interior-point solve with the KKT implicit
    VJP at the polished point (``_solve_ip``'s multipliers); Schur mode
    keeps the forward's ``IPFactors`` for the backward."""

    @staticmethod
    def forward(ctx, config, Q, p, A, b, G, h):
        sol, f, lams = _solve_ip(Q, p, A, b, G, h, config)
        ctx.config, ctx.factors = config, f
        ctx.save_for_backward(sol.x, lams, sol.slacks, sol.nus, Q, A, G)
        return sol.x

    @staticmethod
    def backward(ctx, dl_dz):
        x, lams, slacks, nus, Q, A, G = ctx.saved_tensors
        need = ctx.needs_input_grad          # (config, Q, p, A, b, G, h)
        grads = optnet_grads(
            dl_dz, x, lams, slacks, nus, Q, A, G, ctx.factors,
            float(ctx.config.int_reg), refine=int(ctx.config.refine_steps),
            want_dQ=need[1], want_dA=need[3], want_dG=need[5])
        return (None, *grads)


def qp_optnet(Q, p, A=None, b=None, G=None, h=None,
              config: OptNetConfig = OptNetConfig()):
    """Differentiable interior-point QP layer.  Returns x in the caller's
    layout; with G None it is ``qp_eqcon``.  dQ, dA and dG are built only
    when Q, A or G requires grad."""
    if G is None:
        return qp_eqcon(Q, p, A, b)
    x = _OptNetFunction.apply(config, Q, as_vector(p, "p"), A,
                              as_vector(b, "b"), G, as_vector(h, "h"))
    return like_layout(x, p)


class OptNetLayer(nn.Module):
    """``nn.Module`` holding an ``OptNetConfig``; ``forward`` is
    ``qp_optnet``."""

    def __init__(self, config: OptNetConfig = OptNetConfig()):
        super().__init__()
        self.config = config

    def forward(self, Q, p, A=None, b=None, G=None, h=None):
        return qp_optnet(Q, p, A, b, G, h, config=self.config)
