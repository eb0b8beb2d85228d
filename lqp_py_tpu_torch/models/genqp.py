"""Batched general-inequality QP solver by operator splitting (counterpart
of ``lqp_py_tpu.models.genqp``):

    x* = argmin_x 0.5 x'Qx + p'x   s.t.  Ax = b,  Gx <= h

The whole batch runs lock-step, ADMM with slack consensus:

    x-step:  (Q + rho G'G + sigma I) x = -p + rho G'(h - w + u)  s.t. Ax = b
    s     =  h - Gx
    w     =  max(s + u, 0);     u += s - w

on the Jacobi-scaled, row-equilibrated problem.  The x-step operator is
factored once per rho (``factorize_kkt`` in inverse mode: SWEEP leaves on
the card), so an iteration is one ``Hinv`` GEMV and two G GEMVs.  Duals:
lambda = -rho u >= 0 and nu from the KKT solve.

Where the JAX package traces a ``lax.while_loop``, this module runs a host
loop: the iterations between two residual checks are queued on the device,
and each check reads two flags back ("every element optimal or
infeasible", "some element's rho wants an update"), one synchronization per
check.  The adaptive-rho window depends only on the iteration count, so the
host decides it, and the refactorization runs only when the window is open
and the flag is set, as under ``lax.cond``.

Backward modes (``GenQPConfig.backward``): 'kkt', active-set implicit
differentiation condensed to one n x n SPD solve (``gen_qp_grad_kkt``);
'conic', the SCS-style projection fixed point (models/conic_grad.py), which
falls back to 'kkt' with a warning where its dense system would exceed
``CONIC_BACKWARD_MAX_BYTES``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch
from torch import nn

from lqp_py_tpu_torch.config import GenQPConfig
from lqp_py_tpu_torch.models import box_qp_grad as bgrads
from lqp_py_tpu_torch.models import conic_grad
from lqp_py_tpu_torch.models._polish import (al_lam_threshold,
                                             gen_penalty_polish)
from lqp_py_tpu_torch.models._stateful import StatefulQP
from lqp_py_tpu_torch.ops import anderson, collective
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops.linalg import _mv
from lqp_py_tpu_torch.ops.operator import DENSE
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import QPSolution, as_vector, like_layout
from lqp_py_tpu_torch.utils.profiling import span

_ZERO_CLAMP = 1e-16


def _inf_norm(v):
    return v.abs().amax(dim=-1)


def _row_equilibrate(M, rhs, ops=DENSE):
    """``(E M, E rhs, E)`` with ``E`` the inverse row inf-norms (rows of
    zeros take the mean norm)."""
    norms = ops.row_absmax(M)
    fill = torch.clamp(norms.mean(dim=-1, keepdim=True), min=1e-6)
    norms = torch.where(norms <= 0, fill.expand_as(norms), norms)
    E = 1.0 / norms
    return E[..., :, None] * M, E * rhs, E


def _gen_prep_key(config: GenQPConfig):
    """The config fields baked into a preparation (scaling, auto-rho and
    factorization).  A solve against cached factors must agree on these:
    the in-loop refactorization would otherwise mix two x-step operators
    in one solve."""
    return (float(config.sigma), bool(config.scale),
            None if config.rho is None else float(config.rho),
            float(config.rho_scale), float(config.rho_min),
            float(config.rho_max))


@dataclasses.dataclass
class GenQPPrepared:
    """p-independent state of a general-inequality QP family: scaled data,
    auto-rho and the x-step KKT factorization.

    Produced by ``prepare_qp_gen``, consumed by ``solve_qp_gen_prepared``
    (fixed Q, A, G and h, a drifting p).  Carries ``GtG`` so that the
    in-loop adaptive refactorization works against the cached scaling.
    ``key`` holds the config fields the factors depend on
    (``_gen_prep_key``); a solve with other values raises.
    """
    Qs: torch.Tensor
    As: Optional[torch.Tensor]
    bs: Optional[torch.Tensor]
    Gs: torch.Tensor
    hs: torch.Tensor
    D: torch.Tensor
    EG: torch.Tensor
    EA: Optional[torch.Tensor]
    rho0: torch.Tensor
    GtG: torch.Tensor
    factors: lin.KKTFactors
    key: tuple = ()


def _x_operator(Qs, GtG, rho, sigma, ops=DENSE):
    """``Qs + rho GtG + sigma I``."""
    H = rho[..., None, None] * GtG
    H += Qs
    return ops.add_diag(H, sigma)


def _gen_prepare(Q, A, b, G, h, config, ops=DENSE) -> GenQPPrepared:
    """Everything in the forward solve that does not depend on ``p``.  Q, A
    and G as ``ops`` holds them (``ops/operator.py``; whole by default)."""
    if G is None:
        raise ValueError("solve_qp_gen requires G/h; use solve_qp_eqcon")
    Q = torch.as_tensor(Q)
    if config.symmetrize:
        Q = ops.symmetrize(Q)
    kw = dict(dtype=Q.dtype, device=Q.device)
    G = torch.as_tensor(G).to(**kw)
    h = as_vector(h, "h").to(**kw)
    A = None if A is None else torch.as_tensor(A).to(**kw)
    b = None if b is None else as_vector(b, "b").to(**kw)
    B, n = Q.shape[0], Q.shape[-2]
    k = G.shape[-2]

    with span("lqp.scale"):
        # Scaling: Jacobi D from Q's columns, row equilibration of A and G.
        if config.scale:
            Q_norm = ops.col_absmax(Q)
            fill = torch.clamp(Q_norm.mean(dim=-1, keepdim=True), min=1e-6)
            Q_norm = torch.where(Q_norm <= 0, fill.expand_as(Q_norm), Q_norm)
            D = torch.sqrt(1.0 / Q_norm)
            Dc = ops.cols(D)[..., None, :]
            Qs = D[..., :, None] * Q * Dc
            Gs, hs, EG = _row_equilibrate(G * Dc, h, ops)
            if A is not None:
                As, bs, EA = _row_equilibrate(A * Dc, b, ops)
            else:
                As, bs, EA = None, None, None
        else:
            D = torch.ones((B, n), **kw)
            EG = torch.ones((B, k), **kw)
            EA = None if A is None else torch.ones_like(b)
            Qs, Gs, hs, As, bs = Q, G, h, A, b

        if config.rho is None:
            q_fro = torch.sqrt(ops.sum((Qs * Qs).sum(dim=(-1, -2))))
            rho0 = torch.clamp(config.rho_scale * q_fro / math.sqrt(n),
                               config.rho_min, config.rho_max)
        else:
            rho0 = torch.full((B,), float(config.rho), **kw)

    with span("lqp.factorize"):
        GtG = ops.gram(Gs)
        # The operand is already shifted: H = Qs + rho0 GtG + sigma I.
        factors0 = ops.factorize(
            _x_operator(Qs, GtG, rho0, float(config.sigma), ops), As)
    return GenQPPrepared(Qs=Qs, As=As, bs=bs, Gs=Gs, hs=hs, D=D, EG=EG,
                         EA=EA, rho0=rho0, GtG=GtG, factors=factors0,
                         key=_gen_prep_key(config))


@solver_precision
def prepare_qp_gen(Q, A=None, b=None, G=None, h=None,
                   config: GenQPConfig = GenQPConfig()) -> GenQPPrepared:
    """Precompute the p-independent state (scaling, auto-rho, x-step KKT
    factorization) of a general-inequality QP family for serving."""
    return _gen_prepare(Q, A, b, G, h, config)


def _p_scaled(prep: GenQPPrepared, p):
    pv = as_vector(p, "p").to(dtype=prep.Qs.dtype, device=prep.Qs.device)
    return prep.D * pv, _inf_norm(pv)


@solver_precision
def solve_qp_gen_prepared(prep: GenQPPrepared, p,
                          config: GenQPConfig = GenQPConfig(),
                          warm_start=None) -> QPSolution:
    """Solve for a new cost vector ``p`` against a cached preparation."""
    if prep.key and prep.key != _gen_prep_key(config):
        raise ValueError(
            f"GenQPPrepared was built with "
            f"(sigma, scale, rho, rho_scale, rho_min, rho_max)={prep.key} "
            f"but the solve config has {_gen_prep_key(config)}; re-run "
            f"prepare_qp_gen with the matching config (the cached factors "
            f"and in-loop refactorization must use the same operator)")
    return _solve_gen_scaled(config, prep, *_p_scaled(prep, p), warm_start)


@solver_precision
def solve_qp_gen(Q, p, A=None, b=None, G=None, h=None,
                 config: GenQPConfig = GenQPConfig(),
                 warm_start=None) -> QPSolution:
    """Forward solve; G and h are required (``solve_qp_eqcon`` otherwise).

    Shapes: Q (B,n,n); p (B,n[,1]); A (B,m,n); b (B,m[,1]); G (B,k,n);
    h (B,k[,1]).  Runs on Q's device.

    ``warm_start``: a previous ``QPSolution`` (x, lams, slacks in the
    unscaled layout) to start the iterates from.
    """
    prep = _gen_prepare(Q, A, b, G, h, config)
    return _solve_gen_scaled(config, prep, *_p_scaled(prep, p), warm_start)


def _solve_gen_scaled(config, prep: GenQPPrepared, ps, p_norm,
                      warm_start, ops=DENSE) -> QPSolution:
    """The splitting loop on an already scaled and factorized family, its
    matrices held as ``ops`` holds them."""
    Qs, As, bs, Gs, hs = prep.Qs, prep.As, prep.bs, prep.Gs, prep.hs
    D, EG, EA, rho0 = prep.D, prep.EG, prep.EA, prep.rho0
    dtype, device = ps.dtype, ps.device
    kw = dict(dtype=dtype, device=device)
    B, n = ps.shape
    k = Gs.shape[-2]
    sigma = float(config.sigma)

    eps_abs = max(float(config.eps_abs), 1e-12)
    eps_rel = max(float(config.eps_rel), 1e-12)
    cs = max(int(config.check_solved), 1)
    adaptive_interval = max(round(config.adaptive_rho_iter / cs) * cs, 1)
    max_iters = int(config.max_iters)
    alpha = float(config.alpha)
    m_aa = int(config.acceleration)
    tol_r = float(config.adaptive_rho_tol)
    thr = float(config.adaptive_rho_threshold)
    eps_inf = float(config.eps_infeas)

    if warm_start is not None:
        # Unscaled (x, slacks, lams) into scaled iterates: x_s = x / D,
        # w_s = slacks * EG, u_s = -lams / (rho EG) (lambda = -rho u EG at
        # the fixed point, see the unscale below).
        def _ws(v, name):
            return as_vector(v, name).to(**kw)
        x = _ws(warm_start.x, "warm_start.x") / D
        w = _ws(warm_start.slacks, "warm_start.slacks") * EG
        u = -(_ws(warm_start.lams, "warm_start.lams")
              / (rho0[..., None] * EG))
    else:
        x = torch.zeros((B, n), **kw)
        w = u = torch.zeros((B, k), **kw)
    nu = None if As is None else torch.zeros((B, As.shape[-2]), **kw)
    rho, factors = rho0, prep.factors
    primal_error = torch.full((B,), math.inf, **kw)
    dual_error = torch.full((B,), math.inf, **kw)
    is_optimal = torch.zeros((B,), dtype=torch.bool, device=device)
    u_chk = torch.zeros((B, k), **kw)
    nu_chk = nu
    pinf = torch.zeros((B,), dtype=torch.bool, device=device)
    aa = anderson.aa_init(B, m_aa, 2 * k, dtype, device) if m_aa else None
    # Before the first check the residuals are inf / 1 and the rho ratio is
    # NaN: no element is outside the band, nothing is pending.
    upd_mask = ratio = None
    done, pending = B == 0, False

    def plain_step(w, u):
        """One splitting iteration: (w, u) -> (x, nu, s, w', u')."""
        rhs = -ps + ops.mtv(Gs, rho[..., None] * (hs - w + u))
        x, nu = ops.kkt_apply(factors, rhs, bs)
        s = hs - ops.mv(Gs, x)
        # Over-relaxation on the splitting variable; the fixed point (s = w)
        # is unchanged.
        sh = alpha * s + (1.0 - alpha) * w if alpha != 1.0 else s
        w_new = torch.clamp(sh + u, min=0.0)
        return x, nu, s, w_new, u + (sh - w_new)

    with span("lqp.loop"):
        it = 0
        while it < max_iters and not done:
            if config.adaptive_rho:
                window = (it >= adaptive_interval
                          and it < config.adaptive_rho_max_iter
                          and (it % adaptive_interval) < cs)
                if window and pending:
                    rho_new = torch.where(
                        upd_mask,
                        torch.clamp(rho * ratio, config.rho_min,
                                    config.rho_max),
                        rho)
                    # A rho change rescales the dual estimate u = lambda / rho.
                    u = u * (rho / rho_new)[..., None]
                    rho = rho_new
                    with span("lqp.factorize"):
                        factors = ops.factorize(
                            _x_operator(Qs, prep.GtG, rho, sigma, ops), As)
                    if m_aa:
                        # A new fixed-point map: reset the updated elements'
                        # history.
                        aa = anderson.aa_reset_where(aa, upd_mask)

            n_inner = min(1 if it == 0 else cs, max_iters - it)
            for i in range(n_inner):
                w_prev = w
                x, nu, s, w_new, u_new = plain_step(w, u)
                if m_aa:
                    # Safeguarded Anderson step on v = [w; u]; elements that
                    # were optimal at the last check take the plain step.
                    v_next, aa = anderson.aa_step(
                        aa, torch.cat([w, u], dim=-1),
                        torch.cat([w_new, u_new], dim=-1), (it + i) % m_aa,
                        hold=is_optimal, safeguard=float(config.aa_safeguard),
                        reg=float(config.aa_reg),
                        max_weight=float(config.aa_max_weight))
                    w_new, u_new = v_next[:, :k], v_next[:, k:]
                w, u = w_new, u_new
            it += n_inner

            # Residuals in unscaled units: constraint space through EG, the
            # x-space dual through D.  ``s`` is the last step's h - G x.
            rho_c = rho[..., None]
            primal_error = _inf_norm((s - w) / EG)
            dual_error = _inf_norm(rho_c * ops.mtv(Gs, w - w_prev) * D)
            tolp_norm = torch.clamp(torch.maximum(_inf_norm(s / EG),
                                                  _inf_norm(w / EG)),
                                    min=_ZERO_CLAMP)
            Qx = ops.mv(Qs, x)
            told_norm = torch.clamp(torch.maximum(torch.maximum(
                _inf_norm(ops.mtv(Gs, rho_c * u) * D), _inf_norm(Qx * D)),
                p_norm), min=_ZERO_CLAMP)
            tol_primal = eps_abs + eps_rel * tolp_norm
            tol_dual = eps_abs + eps_rel * told_norm
            is_optimal = (primal_error < tol_primal) & (dual_error < tol_dual)

            # Farkas-style primal-infeasibility certificate (OSQP mechanics,
            # Banjac et al. 2019): a nonnegative dl with G'dl + A'dnu -> 0 and
            # h'dl + b'dnu < 0 proves the constraints infeasible.  Unscaled:
            # dl_us = EG dl_s, (G'dl)_us = (Gs'dl_s) / D.
            if config.detect_infeasibility:
                dl = torch.clamp(-rho_c * (u - u_chk), min=0.0)
                cert = ops.mtv(Gs, dl) / D
                dual_scale = _inf_norm(dl * EG)
                support = (hs * dl).sum(dim=-1)
                if As is not None:
                    dnu = nu - nu_chk
                    cert = cert + ops.mtv(As, dnu) / D
                    dual_scale = torch.maximum(dual_scale, _inf_norm(dnu * EA))
                    support = support + (bs * dnu).sum(dim=-1)
                    nu_chk = nu
                pinf_el = ((_inf_norm(cert) <= eps_inf * dual_scale)
                           & (support <= -eps_inf * dual_scale)
                           & (dual_scale > _ZERO_CLAMP))
                pinf = pinf | (pinf_el & ~is_optimal)
            u_chk = u

            busy = (~(is_optimal | pinf)).any()
            if config.adaptive_rho:
                # The next body's rho test, from this check's residuals.  Only
                # elements not yet converged-enough move.
                do_rho_update = (
                    (primal_error > torch.clamp(tol_primal, min=thr))
                    | (dual_error > torch.clamp(tol_dual, min=thr)))
                num = torch.clamp(primal_error / tolp_norm, min=_ZERO_CLAMP)
                den = torch.clamp(dual_error / told_norm, min=_ZERO_CLAMP)
                ratio = torch.sqrt(num / den)
                outside = (ratio > tol_r) | (ratio < 1.0 / tol_r)
                # The check's one collective over the batch group and one
                # device-to-host read.
                busy, pend, any_out, any_upd = collective.batch_any(
                    torch.stack([busy, (do_rho_update & outside).any(),
                                 outside.any(), do_rho_update.any()]))
                if not config.adaptive_rho_per_element:
                    # The reference's rescale-all: any element out of band
                    # (anywhere in the batch) moves every element still above
                    # its threshold.
                    outside = any_out.expand_as(outside)
                    pend = any_out & any_upd
                upd_mask = do_rho_update & outside
                flags = torch.stack([busy, pend])
                with span("lqp.check"):
                    busy, pending = flags.tolist()
                done = not busy
            else:
                busy = collective.batch_any(busy)
                with span("lqp.check"):
                    done = not bool(busy)

            if config.verbose:
                print(f"genqp iter={it} "
                      f"primal={primal_error.amax().item():.3e} "
                      f"dual={dual_error.amax().item():.3e}")

    # Unscale.  At the fixed point the x-step stationarity reads
    # Qx + p + A'nu + G'[rho (w - s - u)] = 0 with s -> w, so the
    # inequality multiplier is lambda = -rho u (u <= 0 on active rows).
    xs = x
    lam_hat = torch.clamp(-rho[..., None] * u, min=0.0)
    slack_hat = torch.clamp(w, min=0.0)
    nu_hat = nu
    if config.polish:
        xs, lam_hat, slack_hat, nu_hat = _polish(
            Qs, ps, As, bs, Gs, hs, x, w, u, pinf, lam_hat, slack_hat,
            nu_hat, eps_abs, eps_rel, m_aa, ops)
    return QPSolution(
        x=D * xs, lams=lam_hat * EG, slacks=slack_hat / EG,
        nus=None if nu_hat is None else nu_hat * EA, iterations=it,
        primal_residual=primal_error, dual_residual=dual_error,
        converged=is_optimal, primal_infeasible=pinf)


def _polish(Qs, ps, As, bs, Gs, hs, x, w, u, pinf, lam_hat, slack_hat,
            nu_hat, eps_abs, eps_rel, m_aa, ops):
    """Active-set polish on the scaled problem (``gen_penalty_polish``),
    taken per element where it is no less feasible than the iterate and its
    multipliers are nonnegative beyond the AL noise floor.  Returns the
    (possibly polished) ``xs, lam_hat, slack_hat, nu_hat``."""
    dtype = x.dtype
    prox = 10 * (eps_abs + eps_rel)
    if m_aa:
        # Anderson's u is an affine combination: detect by slack proximity.
        act = w <= prox
    else:
        # The slack projection leaves u = 0 on inactive rows; sign of u
        # alone over-detects barely inactive rows, so the projected slack
        # must be near zero as well.
        act = (u < 0) & (w <= prox)
    pol = gen_penalty_polish(Qs, ps, As, bs, Gs, hs, act, ops=ops)

    def viol(xv):
        v = torch.clamp(ops.mv(Gs, xv) - hs, min=0.0).amax(dim=-1)
        if As is not None:
            v = torch.maximum(v, (ops.mv(As, xv) - bs).abs().amax(dim=-1))
        return v

    # A negative AL multiplier on an active row means the guess was wrong;
    # the sign test floors at the AL accumulation's w * eps noise.
    thr_lam = max(eps_abs, al_lam_threshold(dtype))
    ok = ((viol(pol.x) <= torch.clamp(viol(x), min=eps_abs))
          & (pol.lam.amin(dim=-1) >= -thr_lam) & ~pinf)
    okc = ok[..., None]
    xs = torch.where(okc, pol.x, x)
    lam_hat = torch.where(okc, torch.clamp(pol.lam, min=0.0), lam_hat)
    slack_hat = torch.where(okc, torch.clamp(hs - ops.mv(Gs, pol.x),
                                             min=0.0), slack_hat)
    if As is not None:
        nu_hat = torch.where(okc, pol.y, nu_hat)
    return xs, lam_hat, slack_hat, nu_hat


@solver_precision
def gen_qp_grad_kkt(dl_dz, x, lams, slacks, nus, Q, A, G,
                    want_dQ: bool = True, want_dA: bool = True,
                    want_dG: bool = True):
    """Active-set KKT implicit VJP for general G, with clamped multipliers
    and slacks.  The dlam rows are eliminated analytically
    (``dlam = (G dx) / s`` from the complementarity row), which leaves the
    n x n SPD-condensed system

        [(Q + G^T diag(lam/s) G), A^T; A, 0] [dx; dnu] = [-dl_dz; 0]

    solved through ``spd_solve_fast``.  Returns (dQ, dp, dA, db, dG, dh);
    ``want_*`` = False returns None in place of dQ, dA, dG."""
    lams_c = torch.clamp(lams, min=1e-8)
    slacks_c = torch.clamp(slacks, 1e-8, 1e12)
    w = lams_c / slacks_c                                # (B, k)
    H = Q + G.mT @ (w[..., None] * G)
    dx, dnu = bgrads.reduced_kkt_solve(H, A, -dl_dz, reg=1e-8)
    dlam = _mv(G, dx) / slacks_c
    return bgrads.qp_int_grads(x, lams_c, nus, dx, dlam, dnu,
                               want_dQ=want_dQ, want_dA=want_dA,
                               want_dG=want_dG)


@solver_precision
def _genqp_grads(config, dl_dz, x, lams, slacks, nus, Q, A, G, want_dQ,
                 want_dA, want_dG):
    """The layer's VJP in ``config.backward``'s mode, with the conic mode's
    memory guard."""
    backward = config.backward
    if backward == "conic":
        need = conic_grad.conic_backward_bytes(
            Q.shape[0], Q.shape[-1], 0 if A is None else A.shape[-2],
            G.shape[-2], Q.element_size())
        budget = conic_grad.CONIC_BACKWARD_MAX_BYTES
        if need > budget:
            warnings.warn(
                f"backward='conic' would materialize a dense "
                f"{need / 2**30:.1f} GiB self-dual system at this shape "
                f"(budget {budget / 2**30:.1f} GiB); "
                f"falling back to the condensed 'kkt' rule — equivalent "
                f"gradients for a converged solution, n x n memory",
                stacklevel=3)
            backward = "kkt"
    want = dict(want_dQ=want_dQ, want_dA=want_dA, want_dG=want_dG)
    if backward == "conic":
        return conic_grad.conic_qp_grads(dl_dz, x, lams, slacks, Q, A, G,
                                         **want)
    if backward == "kkt":
        return gen_qp_grad_kkt(dl_dz, x, lams, slacks, nus, Q, A, G, **want)
    raise ValueError(f"unknown backward mode {backward!r}")


class _GenQPFunction(torch.autograd.Function):
    """Canonical-layout ((B, n)) splitting solve with the implicit VJP."""

    @staticmethod
    def forward(ctx, config, Q, p, A, b, G, h):
        sol = solve_qp_gen(Q, p, A, b, G, h, config)
        ctx.config = config
        ctx.save_for_backward(sol.x, sol.lams, sol.slacks, sol.nus, Q, A, G)
        return sol.x

    @staticmethod
    def backward(ctx, dl_dz):
        x, lams, slacks, nus, Q, A, G = ctx.saved_tensors
        need = ctx.needs_input_grad          # (config, Q, p, A, b, G, h)
        return (None, *_genqp_grads(
            ctx.config, dl_dz, x, lams, slacks, nus, Q, A, G,
            want_dQ=need[1], want_dA=need[3], want_dG=need[5]))


def qp_gen(Q, p, A=None, b=None, G=None, h=None,
           config: GenQPConfig = GenQPConfig()):
    """Differentiable general-QP layer.  Returns x in the caller's layout;
    dQ, dA and dG are built only when Q, A or G requires grad."""
    x = _GenQPFunction.apply(config, Q, as_vector(p, "p"), A,
                             as_vector(b, "b"), G, as_vector(h, "h"))
    return like_layout(x, p)


class GenQPLayer(nn.Module):
    """``nn.Module`` holding a ``GenQPConfig``; ``forward`` is ``qp_gen``."""

    def __init__(self, config: GenQPConfig = GenQPConfig()):
        super().__init__()
        self.config = config

    def forward(self, Q, p, A=None, b=None, G=None, h=None):
        return qp_gen(Q, p, A, b, G, h, config=self.config)


class GenQP(StatefulQP):
    """Stateful solve/update wrapper for the general-inequality solver:
    p-only updates keep the cached scaling and factorization, and
    ``warm_start=True`` starts each solve from the previous solution."""

    _extra_fields = ("G", "h")

    def __init__(self, Q, p, A=None, b=None, G=None, h=None,
                 control: GenQPConfig = GenQPConfig(),
                 warm_start: bool = False):
        self._init(Q, p, A, b, G, h, control, warm_start)

    def _prepare(self):
        return prepare_qp_gen(self.Q, self.A, self.b, self.G, self.h,
                              config=self.control)

    def _solve_prepared(self, prep, p, warm_start):
        return solve_qp_gen_prepared(prep, p, config=self.control,
                                     warm_start=warm_start)

    def update(self, Q=None, p=None, A=None, b=None, G=None, h=None,
               control=None):
        self._update(Q, p, A, b, G, h, control)
