"""Box-structured Mehrotra interior point (counterpart of
``lqp_py_tpu.models.box_ip``): the OptNet algorithm with the box
``G = [-I; I]`` exploited analytically, so the condensed Newton operator is

    H(d) = Q + diag(d_lo + d_hi)

and every G product is elementwise; per iteration only the n x n inverse
(``spd_inverse_fast``, SWEEP leaves in float32) remains.  The same
predictor-corrector steps, relative stopping test and two-round
active-set polish as ``models/optnet.py``.

The polish's acceptance reads the equality residual beyond its rounding
(``_polish.equality_excess``), where the JAX package reads it whole, and a
third round runs on the elements where round 2 narrowly failed.

Requires finite bounds.  The JAX package's ``lax.while_loop`` is a host
loop here with one device read per iteration (``converged.all()``):
each iteration already carries a factorization.  Converged elements are
frozen (step length 0) and the batch runs as many iterations as in the JAX
package.  The backward is the box KKT implicit VJP
(``box_qp_grad_kkt``), whose ``lams`` layout [lambda_lb; lambda_ub] this
solver returns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lqp_py_tpu_torch.config import OptNetConfig
from lqp_py_tpu_torch.models import box_qp_grad as bgrads
from lqp_py_tpu_torch.models._polish import (PolishResult,
                                             acceptance_threshold, accepted,
                                             box_penalty_polish,
                                             equality_excess, polish_rounds)
from lqp_py_tpu_torch.models.optnet import _d_cap, _inf_norm, _step_length
from lqp_py_tpu_torch.ops import collective
from lqp_py_tpu_torch.ops.linalg import _mv
from lqp_py_tpu_torch.ops.operator import DENSE
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import BoxQPSolution, as_vector, like_layout


class _Factors(NamedTuple):
    Hinv: torch.Tensor
    W: Optional[torch.Tensor]
    Sinv: Optional[torch.Tensor]


def _factor(ops, Q, A, diag, int_reg):
    """Inverse of ``Q + diag(diag) + int_reg I`` plus the A-Schur pieces."""
    Hinv = ops.inverse(ops.add_diag(Q.clone(), diag + int_reg))
    if A is None:
        return _Factors(Hinv=Hinv, W=None, Sinv=None)
    return _Factors(Hinv, *ops.schur(Hinv, A, int_reg))


def _solve(ops, fc: _Factors, A, rhs1, ry):
    """[[H, A'], [A, 0]] [dx; dy] = [rhs1; -ry] through the factors."""
    t = ops.mv(fc.Hinv, rhs1)
    if A is None:
        return t, None
    dy = _mv(fc.Sinv, ops.mv(A, t) + ry)
    return t - _mv(fc.W, dy), dy


class _State(NamedTuple):
    x: torch.Tensor
    s_lo: torch.Tensor
    s_hi: torch.Tensor
    z_lo: torch.Tensor
    z_hi: torch.Tensor
    y: Optional[torch.Tensor]
    primal: torch.Tensor
    dual: torch.Tensor
    converged: torch.Tensor


@solver_precision
def solve_box_qp_ip(Q, p, A=None, b=None, lb=None, ub=None,
                    config: OptNetConfig = OptNetConfig()) -> BoxQPSolution:
    """Forward box-IP solve.  Shapes as ``solve_box_qp``; bounds must be
    finite.  Returns a BoxQPSolution with ``z = clip(x, lb, ub)``, ``u`` the
    net bound dual ``z_hi - z_lo`` and ``rho`` all ones."""
    return _solve_box_ip(DENSE, Q, p, A, b, lb, ub, config)


def _solve_box_ip(ops, Q, p, A, b, lb, ub, config) -> BoxQPSolution:
    """``solve_box_qp_ip`` with Q and A as ``ops`` holds them
    (``ops/operator.py``)."""
    Q = torch.as_tensor(Q)
    if config.symmetrize:
        Q = ops.symmetrize(Q)
    dtype = Q.dtype
    p = as_vector(p, "p").to(dtype)
    lb = as_vector(lb, "lb").to(dtype)
    ub = as_vector(ub, "ub").to(dtype)
    A = None if A is None else torch.as_tensor(A).to(dtype)
    b = None if b is None else as_vector(b, "b").to(dtype)
    B, n = p.shape

    int_reg = float(config.int_reg)
    tol = float(config.tol)
    eps_abs = eps_rel = tol
    p_norm, lb_norm, ub_norm = _inf_norm(p), _inf_norm(lb), _inf_norm(ub)
    b_norm = None if b is None else _inf_norm(b)

    # Init: one solve at d = 1 on both sides (H = Q + 2I); rhs1 = -p + G'h
    # with G'h = lb + ub; then s shifted to >= 1, z = 1.
    ones = torch.ones_like(p)
    x0, y0 = _solve(ops, _factor(ops, Q, A, 2.0 * ones, int_reg), A,
                    -p + (lb + ub), None if b is None else -b)
    s_lo0, s_hi0 = x0 - lb, ub - x0
    shift_s = torch.clamp(1.0 - torch.minimum(s_lo0.amin(dim=-1),
                                              s_hi0.amin(dim=-1)), min=0.0)
    inf_b = torch.full((B,), torch.inf, dtype=dtype, device=p.device)
    st = _State(x=x0, s_lo=s_lo0 + shift_s[..., None],
                s_hi=s_hi0 + shift_s[..., None], z_lo=ones, z_hi=ones, y=y0,
                primal=inf_b, dual=inf_b,
                converged=torch.zeros((B,), dtype=torch.bool,
                                      device=p.device))
    d_cap = _d_cap(dtype)

    def body(st: _State) -> _State:
        Qx = ops.mv(Q, st.x)
        # rx = Qx + p + G'z with G'z = z_hi - z_lo (+ A'y).
        rx = Qx + p - st.z_lo + st.z_hi
        ry = Aty = None
        if A is not None:
            Aty = ops.mtv(A, st.y)
            rx = rx + Aty
            ry = ops.mv(A, st.x) - b
        # rz = Gx + s - h: lo rows -x + s_lo + lb, hi rows x + s_hi - ub.
        rz_lo = -st.x + st.s_lo + lb
        rz_hi = st.x + st.s_hi - ub

        prim = torch.maximum(_inf_norm(rz_lo), _inf_norm(rz_hi))
        tolp_norm = torch.maximum(
            torch.maximum(_inf_norm(st.x), torch.maximum(
                _inf_norm(st.s_lo), _inf_norm(st.s_hi))),
            torch.maximum(lb_norm, ub_norm))
        dual = _inf_norm(rx)
        told_norm = torch.maximum(
            torch.maximum(_inf_norm(Qx), p_norm),
            torch.maximum(_inf_norm(st.z_lo), _inf_norm(st.z_hi)))
        if ry is not None:
            prim = torch.maximum(prim, _inf_norm(ry))
            tolp_norm = torch.maximum(tolp_norm, b_norm)
            told_norm = torch.maximum(told_norm, _inf_norm(Aty))
        comp = torch.maximum((st.s_lo * st.z_lo).amax(dim=-1),
                             (st.s_hi * st.z_hi).amax(dim=-1))
        z_norm = torch.maximum(_inf_norm(st.z_lo), _inf_norm(st.z_hi))
        conv_el = ((prim < eps_abs + eps_rel * tolp_norm)
                   & (dual < eps_abs + eps_rel * told_norm)
                   & (comp < eps_abs + eps_rel * z_norm))

        d_lo = torch.clamp(st.z_lo / st.s_lo, 1.0 / d_cap, d_cap)
        d_hi = torch.clamp(st.z_hi / st.s_hi, 1.0 / d_cap, d_cap)
        fc = _factor(ops, Q, A, d_lo + d_hi, int_reg)

        def newton(rx_, rs_lo, rs_hi, rz_lo_, rz_hi_, ry_):
            # rhs1 = -rx + G'(rs - d rz) with G'v = v_hi - v_lo.
            rhs1 = (-rx_ - (rs_lo - d_lo * rz_lo_)
                    + (rs_hi - d_hi * rz_hi_))
            dx, dy = _solve(ops, fc, A, rhs1, ry_)
            ds_lo = -rz_lo_ + dx          # ds = -rz - G dx
            ds_hi = -rz_hi_ - dx
            return (dx, ds_lo, ds_hi, -rs_lo - d_lo * ds_lo,
                    -rs_hi - d_hi * ds_hi, dy)

        # Affine (predictor) step.
        dxa, dsla, dsha, dzla, dzha, dya = newton(
            rx, st.z_lo, st.z_hi, rz_lo, rz_hi, ry)
        alpha = _step_length(((st.z_lo, dzla), (st.z_hi, dzha),
                               (st.s_lo, dsla), (st.s_hi, dsha)))
        mu = (st.s_lo * st.z_lo + st.s_hi * st.z_hi).sum(dim=-1) / (2 * n)
        mu_aff = ((st.s_lo + alpha * dsla) * (st.z_lo + alpha * dzla)
                  + (st.s_hi + alpha * dsha)
                  * (st.z_hi + alpha * dzha)).sum(dim=-1) / (2 * n)
        sig = (mu_aff / mu) ** 3

        # Centering-corrector step.
        rs_lo_c = ((-mu * sig)[..., None] + dsla * dzla) / st.s_lo
        rs_hi_c = ((-mu * sig)[..., None] + dsha * dzha) / st.s_hi
        dxc, dslc, dshc, dzlc, dzhc, dyc = newton(
            torch.zeros_like(rx), rs_lo_c, rs_hi_c, torch.zeros_like(rz_lo),
            torch.zeros_like(rz_hi), None if ry is None
            else torch.zeros_like(ry))

        dx = dxa + dxc
        ds_lo, ds_hi = dsla + dslc, dsha + dshc
        dz_lo, dz_hi = dzla + dzlc, dzha + dzhc
        alpha = torch.where(conv_el[..., None], 0.0, _step_length(
            ((st.z_lo, dz_lo), (st.z_hi, dz_hi), (st.s_lo, ds_lo),
             (st.s_hi, ds_hi))))
        return _State(
            x=st.x + alpha * dx, s_lo=st.s_lo + alpha * ds_lo,
            s_hi=st.s_hi + alpha * ds_hi, z_lo=st.z_lo + alpha * dz_lo,
            z_hi=st.z_hi + alpha * dz_hi,
            y=None if st.y is None else st.y + alpha * (dya + dyc),
            primal=prim, dual=dual, converged=conv_el)

    it = 0
    while it < config.max_iters:
        st = body(st)
        it += 1
        if not bool(collective.batch_any((~st.converged).any())):
            break

    x_fin, y_fin = st.x, st.y
    if config.polish:
        # Active-set polish in box form (models/_polish.py).
        def _viol(xv, k):
            # The refinement corrects through Hinv only, so the equality
            # residual is part of the acceptance test, read beyond its
            # rounding (``equality_excess``).  ``k``: the elements xv
            # belongs to.
            v = torch.maximum(lb[k] - xv, xv - ub[k]).amax(dim=-1)
            if A is not None:
                v = torch.maximum(v, equality_excess(A[k], b[k], xv, ops))
            return v

        thr = acceptance_threshold(tol, torch.maximum(lb_norm, ub_norm))
        viol_ip = _viol(st.x, slice(None))
        # Classify against slacks recomputed from x, not the IP's slack
        # variables, which drift from x - lb by the primal residual.
        act = (st.z_lo > (st.x - lb), st.z_hi > (ub - st.x))

        def solve(a, k):
            return box_penalty_polish(
                Q[k], p[k], None if A is None else A[k],
                None if b is None else b[k], lb[k], ub[k], act_lo=a[0][k],
                act_hi=a[1][k], ops=ops)

        thr_c = thr[..., None]

        def repair(a, pr):
            # Release bounds whose multiplier came back negative, add
            # bounds the point violates.
            return ((a[0] & (pr.lam_lo >= -thr_c)) | (lb - pr.x > thr_c),
                    (a[1] & (pr.lam_hi >= -thr_c)) | (pr.x - ub > thr_c))

        def ok(pr, k, within):
            return accepted(_viol(pr.x, k), viol_ip[k], thr[k],
                            torch.minimum(pr.lam_lo, pr.lam_hi).amin(dim=-1),
                            thr[k], within)

        fin = polish_rounds(solve, repair, ok, act, PolishResult(
            x=st.x, y=st.y, lam_lo=st.z_lo, lam_hi=st.z_hi))
        x_fin, y_fin = fin.x, fin.y

    lams = torch.cat([torch.clamp(st.z_lo, min=1e-8),
                      torch.clamp(st.z_hi, min=1e-8)], dim=-1)
    return BoxQPSolution(
        x=x_fin, z=torch.clamp(x_fin, lb, ub), u=st.z_hi - st.z_lo,
        lams=lams, nus=y_fin, rho=torch.ones((B,), dtype=dtype,
                                             device=p.device),
        iterations=it, primal_residual=st.primal, dual_residual=st.dual,
        converged=st.converged)


class _BoxIPFunction(torch.autograd.Function):
    """Canonical-layout ((B, n)) box-IP solve with the KKT implicit VJP."""

    @staticmethod
    def forward(ctx, config, Q, p, A, b, lb, ub):
        sol = solve_box_qp_ip(Q, p, A, b, lb, ub, config)
        ctx.save_for_backward(sol.x, sol.lams, sol.nus, Q, A, lb, ub)
        return sol.x

    @staticmethod
    def backward(ctx, dl_dz):
        x, lams, nus, Q, A, lb, ub = ctx.saved_tensors
        need = ctx.needs_input_grad          # (config, Q, p, A, b, lb, ub)
        dQ, dp, dA, db, dlb, dub = bgrads.box_qp_grad_kkt(
            dl_dz, x, lams, nus, Q, A, lb, ub, want_dQ=need[1],
            want_dA=need[3])
        if A is None:
            dA, db = None, None
        return None, dQ, dp, dA, db, dlb, dub


def boxqp_ip(Q, p, A=None, b=None, lb=None, ub=None,
             config: OptNetConfig = OptNetConfig()):
    """Differentiable box-QP layer solved by the structured interior point
    (KKT implicit backward).  Returns x in the caller's layout; dQ and dA
    are built only when Q or A requires grad."""
    x = _BoxIPFunction.apply(config, Q, as_vector(p, "p"), A,
                             as_vector(b, "b"), as_vector(lb, "lb"),
                             as_vector(ub, "ub"))
    return like_layout(x, p)
