"""Batched box-QP ADMM solver, forward pass (counterpart of
``lqp_py_tpu.models.box_qp``).

Solves (batched over a leading axis)

    x* = argmin_x  0.5 x'Qx + p'x
         s.t.      A x = b          (optional equality constraints)
                   lb <= x <= ub    (box, entries may be +/-inf)

with the JAX package's iteration, step for step: Jacobi scaling with a
quantile-blended beta, a reduced-KKT inverse applied as one dense GEMV per
iteration, an OSQP-style stopping test on unscaled residuals every ``cs``
iterations, a primal-infeasibility certificate, and per-element adaptive
rho with refactorization.  With ``use_pallas_step`` each iteration is the
early-exit step instead (``ops/kernels/admm_step.py``): one GEMV against
the materialized reduced inverse ``P`` that skips converged elements,
which stay frozen until the batch stops.  Where the JAX package traces a
``lax.while_loop``, this module runs a Python loop: the ``cs`` iterations
between two residual checks are queued on the device, and each check reads
two flags back to the host ("every element done", "some rho pending"),
one synchronization per check.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops import scaling as sca
from lqp_py_tpu_torch.ops.kernels.admm_step import fused_admm_step
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import BoxQPSolution, as_vector

_ZERO_CLAMP = 1e-16


def _inf_norm(v):
    return v.abs().amax(dim=-1)


def _prep_h(Q, p, A, b, lb, ub, config, pad: int = 0):
    """Canonicalize shapes, take the unscaled p-norm, and build the scaled,
    lane-padded factorization operand ``H = D Q D + rho I`` in one pass
    (``scale_problem_h``).  Every input moves to Q's device and dtype."""
    Q = torch.as_tensor(Q)
    if config.symmetrize:
        Q = 0.5 * (Q + Q.mT)
    kw = dict(dtype=Q.dtype, device=Q.device)
    p = as_vector(p, "p").to(**kw)
    A = None if A is None else torch.as_tensor(A).to(**kw)
    b = None if b is None else as_vector(b, "b").to(**kw)
    B, n = p.shape
    lb = (torch.full((B, n), -math.inf, **kw) if lb is None
          else as_vector(lb, "lb").to(**kw))
    ub = (torch.full((B, n), math.inf, **kw) if ub is None
          else as_vector(ub, "ub").to(**kw))

    # The dual tolerance uses the unscaled p-norm.
    p_norm = _inf_norm(p)
    # With no finite bound anywhere in the batch the box projection is the
    # identity and rho is forced to 0: ADMM then converges in one step.
    any_ineq = (lb.amax() > -math.inf) | (ub.amin() < math.inf)

    def rho_fn(D, q_fro):
        if config.rho is None:
            r = torch.clamp(config.rho_scale * q_fro / math.sqrt(n),
                            config.rho_min, config.rho_max)
        else:
            r = torch.full((B,), float(config.rho), **kw)
        return torch.where(any_ineq, r, torch.zeros_like(r))

    sph, rho = sca.scale_problem_h(Q, p, A, b, lb, ub, rho_fn,
                                   beta=config.beta, pad=pad,
                                   scale=config.scale)
    return sph, p_norm, rho


def _check_supported(config: BoxQPConfig) -> None:
    if config.kkt_solver not in ("inverse", "cholesky"):
        raise ValueError(f"unknown kkt_solver {config.kkt_solver!r}")
    later = [name for name, on in (
        ("polish=True", config.polish),
        ("acceleration>0", config.acceleration > 0),
        ("kkt_solver='cholesky'", config.kkt_solver == "cholesky"),
    ) if on]
    if later:
        raise NotImplementedError(
            f"lqp_py_tpu_torch does not port {', '.join(later)} yet: the "
            f"forward slice covers the inverse-mode ADMM solve; polish, "
            f"Anderson acceleration and the Cholesky KKT mode come with "
            f"later slices of the port")


#: Lane alignment of the variable axis.  The port keeps the JAX package's
#: padding (128, or 256 for the early-exit step) so that its iterates match
#: step for step; padded coordinates are inert (p = 0, bounds +/-inf,
#: identity block in H).  The CUDA kernels take any n.
_ALIGN = 128


def _padded_n(config: BoxQPConfig, n: int) -> int:
    align = 256 if config.use_pallas_step else _ALIGN
    return -(-n // align) * align


def _pad_identity(M, pad):
    """Pad (B, n, n) to (B, n+pad, n+pad) with an identity block."""
    n = M.shape[-1]
    out = F.pad(M, (0, pad, 0, pad))
    out.diagonal(dim1=-2, dim2=-1)[:, n:] = 1.0
    return out


def _pad_factors(f: lin.KKTFactors, pad: int) -> lin.KKTFactors:
    """Resize cached KKT factors to the solve's aligned size.

    pad > 0: zero-pad P/Hinv and W/WS's rows (the padded coordinates' r is
    identically 0).  pad < 0: slice, which is exact because the factors
    were built from an identity-padded H with zero-padded A columns: the
    padded block decouples, so P, Hinv and W restrict to the leading block.
    This happens when ``prepare_box_qp`` aligned to another tile than the
    solve-time config (e.g. prepared for the early-exit step at 256, solved
    without it at 128)."""
    if pad < 0:
        def nn(a):
            return a[..., :pad, :pad]

        def nm(a):
            return a[..., :pad, :]
    else:
        def nn(a):
            return F.pad(a, (0, pad, 0, pad))

        def nm(a):
            return F.pad(a, (0, 0, 0, pad))

    def opt(fn, a):
        return None if a is None else fn(a)

    return dataclasses.replace(f, P=opt(nn, f.P), Hinv=opt(nn, f.Hinv),
                               W=opt(nm, f.W), WS=opt(nm, f.WS))


@solver_precision
def solve_box_qp(Q, p, A=None, b=None, lb=None, ub=None,
                 config: BoxQPConfig = BoxQPConfig(),
                 warm_start=None) -> BoxQPSolution:
    """Forward box-QP solve (no gradient).

    Shapes: Q (B,n,n); p/lb/ub (B,n) or (B,n,1); A (B,m,n); b (B,m)/(B,m,1).
    Runs on Q's device.

    ``warm_start``: optional previous ``BoxQPSolution`` (or any object with
    ``x``, ``z``, ``u`` in unscaled (B, n) layout) to start the iterates
    from.
    """
    _check_supported(config)
    nv = as_vector(p, "p").shape[-1]
    sph, p_norm, rho0 = _prep_h(Q, p, A, b, lb, ub, config,
                                pad=_padded_n(config, nv) - nv)
    return _solve_scaled(config, sph.p, sph.A, sph.b, sph.lb, sph.ub,
                         sph.D, sph.E, p_norm, rho0, None, warm_start,
                         H0=sph.H)


@dataclasses.dataclass
class BoxQPPrepared:
    """p-independent state of a box-QP family: scaled data + KKT factors.

    Produced by ``prepare_box_qp``, consumed by ``solve_box_qp_prepared``:
    where Q, A, b and the bounds are fixed and only p changes between
    solves, the scaling and the factorization are paid once.  ``H`` is the
    lane-padded factorization operand ``D Q D + rho0 I``, the same object
    the direct solve builds, so a prepared solve reproduces a direct one.
    """
    H: torch.Tensor
    As: Optional[torch.Tensor]
    bs: Optional[torch.Tensor]
    lbs: torch.Tensor
    ubs: torch.Tensor
    D: torch.Tensor
    E: Optional[torch.Tensor]
    rho0: torch.Tensor
    factors: lin.KKTFactors


@solver_precision
def prepare_box_qp(Q, A=None, b=None, lb=None, ub=None,
                   config: BoxQPConfig = BoxQPConfig()) -> BoxQPPrepared:
    """Precompute everything that does not depend on ``p``: scaling,
    auto-rho, and the KKT factorization."""
    _check_supported(config)
    Q = torch.as_tensor(Q)
    n = Q.shape[-1]
    p0 = Q.new_zeros(Q.shape[:-1])
    sph, _p_norm, rho0 = _prep_h(Q, p0, A, b, lb, ub, config,
                                 pad=_padded_n(config, n) - n)
    factors = lin.factorize_kkt(sph.H, None, sph.A,
                                equilibrate=not config.scale,
                                materialize_p=config.use_pallas_step)
    return BoxQPPrepared(H=sph.H, As=sph.A, bs=sph.b, lbs=sph.lb,
                         ubs=sph.ub, D=sph.D, E=sph.E, rho0=rho0,
                         factors=factors)


@solver_precision
def solve_box_qp_prepared(prep: BoxQPPrepared, p,
                          config: BoxQPConfig = BoxQPConfig(),
                          warm_start=None) -> BoxQPSolution:
    """Solve for a new cost vector ``p`` against a cached preparation."""
    _check_supported(config)
    pv = as_vector(p, "p").to(dtype=prep.H.dtype, device=prep.H.device)
    p_norm = _inf_norm(pv)
    ps = prep.D * pv
    return _solve_scaled(config, ps, prep.As, prep.bs, prep.lbs, prep.ubs,
                         prep.D, prep.E, p_norm, prep.rho0, prep.factors,
                         warm_start, H0=prep.H)


def _solve_scaled(config, ps, As, bs, lbs, ubs, D, E, p_norm, rho0,
                  factors_in, warm_start, H0) -> BoxQPSolution:
    """The ADMM loop on an already-scaled problem.

    ``H0`` is the lane-padded factorization operand ``D Q D + rho0 I``;
    ``As`` arrives with zero pad columns.  ``factors_in`` are cached
    factors of ``H0`` (prepared solve) or None (factorize here).  A
    preparation made at another alignment than this solve's is resized:
    the identity pad is extended or sliced off."""
    B, n = ps.shape
    dtype, device = ps.dtype, ps.device
    cs = config.resolved_check_interval(n)
    adaptive_interval = config.resolved_adaptive_interval(n)
    max_iters = int(config.max_iters)
    use_pallas = bool(config.use_pallas_step)
    n_pad = _padded_n(config, n)
    pad = n_pad - n
    built = H0.shape[-1]
    if built < n_pad:
        H0 = _pad_identity(H0, n_pad - built)
        As = None if As is None else F.pad(As, (0, n_pad - built))
    elif built > n_pad:
        H0 = H0[:, :n_pad, :n_pad]
        As = None if As is None else As[:, :, :n_pad]
    ps_p = F.pad(ps, (0, pad))
    lbs_p = F.pad(lbs, (0, pad), value=-math.inf)
    ubs_p = F.pad(ubs, (0, pad), value=math.inf)
    As_u = None if As is None else As[:, :, :n]
    equilibrate = not config.scale

    def _q_of(f):
        return lin.kkt_step_operator(f, bs)[1]

    def factorize(rho):
        # Shift only the leading-n diagonal: the pad block's identity stays
        # put, so a downward rho move cannot push its pivots toward zero.
        Hr = H0.clone()
        Hr.diagonal(dim1=-2, dim2=-1)[:, :n] += (rho - rho0)[:, None]
        f = lin.factorize_kkt(Hr, None, As, equilibrate=equilibrate,
                              materialize_p=use_pallas)
        return f, _q_of(f)

    if factors_in is None:
        factors = lin.factorize_kkt(H0, None, As, equilibrate=equilibrate,
                                    materialize_p=use_pallas)
    else:
        factors = factors_in
        if use_pallas and factors.P is None:
            # Prepared without P but the early-exit step wants it: build it
            # from the cached pieces (one GEMM, no refactorization).
            factors = dataclasses.replace(
                factors, P=factors.Hinv if factors.W is None
                else factors.Hinv - factors.WS @ factors.W.mT)
        dense = factors.P if factors.P is not None else factors.Hinv
        if dense.shape[-1] != n_pad:
            factors = _pad_factors(factors, n_pad - dense.shape[-1])
    q = _q_of(factors)

    # Over-relaxation collapses to alpha = 1 when no bound is finite (rho
    # is 0 there and the plain iteration converges in one step).
    has_alpha = float(config.alpha) != 1.0
    any_finite = (lbs.amax() > -math.inf) | (ubs.amin() < math.inf)
    alpha_t = torch.where(any_finite,
                          torch.tensor(float(config.alpha), dtype=dtype,
                                       device=device),
                          torch.tensor(1.0, dtype=dtype, device=device))

    def x_update(f, q, r):
        # x = P r + q where P is materialized, else x = Hinv r - WS (W^T r)
        # + q: one dense GEMV and two rank-n_eq corrections.
        if f.P is not None:
            return lin._mv(f.P, r) + q
        y = lin._mv(f.Hinv, r)
        if f.W is not None:
            y = y - lin._mv(f.WS, lin._mv(f.W.mT, r))
        return y + q

    if warm_start is not None:
        # Map the previous (unscaled) iterates into the current scaling.
        def _w(v, scale_mul):
            v = as_vector(v, "warm_start").to(dtype=dtype, device=device)
            return F.pad(v * scale_mul, (0, pad))
        x = _w(warm_start.x, 1.0 / D)
        z = _w(warm_start.z, 1.0 / D)
        u = _w(warm_start.u, D)
    else:
        x = z = u = torch.zeros((B, n_pad), dtype=dtype, device=device)

    it = 0
    last_r = -ps_p
    rho = rho0
    primal_error = torch.full((B,), math.inf, dtype=dtype, device=device)
    dual_error = torch.full((B,), math.inf, dtype=dtype, device=device)
    tolp_norm = torch.ones((B,), dtype=dtype, device=device)
    told_norm = torch.ones((B,), dtype=dtype, device=device)
    is_optimal = torch.zeros((B,), dtype=torch.bool, device=device)
    u_chk = u[:, :n]
    nu_chk = (None if As is None else
              torch.zeros((B, As.shape[-2]), dtype=dtype, device=device))
    # Crossed bounds (lb > ub) make the box itself empty: flagged from the
    # data before the first iteration.
    pinf = (torch.any(lbs > ubs, dim=-1) if config.detect_infeasibility
            else torch.zeros((B,), dtype=torch.bool, device=device))
    rho_pending = torch.zeros((B,), dtype=torch.bool, device=device)
    K = int(config.residual_trace)
    trace = (torch.full((K, 3), -1.0, dtype=dtype, device=device)
             if K else None)
    n_chk = 0

    eps_abs = max(float(config.eps_abs), 1e-12)
    eps_rel = max(float(config.eps_rel), 1e-12)
    eps_inf = float(config.eps_infeas)
    thr = float(config.adaptive_rho_threshold)
    tol_r = float(config.adaptive_rho_tol)

    def rho_ratio():
        """Adaptive-rho signal sqrt(primal_ratio / dual_ratio) from the
        residuals of the last check."""
        num = torch.clamp(primal_error / tolp_norm, min=_ZERO_CLAMP)
        den = torch.clamp(dual_error / told_norm, min=_ZERO_CLAMP)
        return torch.sqrt(num / den)

    def flags():
        """(every element optimal or infeasible, some rho pending): the one
        device-to-host read of a residual check."""
        done, pending = torch.stack(
            [torch.all(is_optimal | pinf), torch.any(rho_pending)]).tolist()
        return done, pending

    done, pending = flags()
    while True:
        # Inner loop: residual-check blocks until every element is done,
        # the iteration cap is hit, or some element's rho must update.
        while it < max_iters and not done and not pending:
            # The first check comes after a single iteration, then every cs.
            n_inner = min(1 if it == 0 else cs, max_iters - it)
            rho_c = rho[..., None]
            if use_pallas:
                # Early-exit step, frozen where the last check found an
                # element optimal.  alpha is static here: no collapse to 1
                # without finite bounds (the JAX package's fused step
                # assumes a genuinely box-constrained problem).
                a = float(config.alpha)
                r = -ps_p + rho_c * (z - u)
                for _ in range(n_inner):
                    z_prev = z
                    x, z, u, r = fused_admm_step(
                        factors.P, r, x, z, u, ps_p, q, lbs_p, ubs_p, rho,
                        is_optimal, alpha=a)
                # r now feeds the next iteration.  The r that produced x is
                # rebuilt by inverting the (relaxed) dual update
                # u = u_prev + (a x + (1 - a) z_prev - z); frozen elements
                # keep the r that actually produced their x.
                u_prev = u - (a * x + (1.0 - a) * z_prev - z)
                last_r = torch.where(is_optimal[:, None], last_r,
                                     -ps_p + rho_c * (z_prev - u_prev))
            else:
                for _ in range(n_inner):
                    r = -ps_p + rho_c * (z - u)
                    x = x_update(factors, q, r)
                    z_prev = z
                    xh = alpha_t * x + (1.0 - alpha_t) * z if has_alpha else x
                    z = torch.clamp(xh + u, lbs_p, ubs_p)
                    u = u + (xh - z)
                last_r = r
            xs_c, zs_c, us_c, zp_c = (v[:, :n] for v in (x, z, u, z_prev))

            # Equality duals implied by the current factored solve.
            nu_s = None
            if As is not None:
                nu_s = lin._mv(factors.Sinv, lin._mv(factors.W.mT, last_r)
                               - bs)

            # OSQP-style stopping test on unscaled residuals.
            s_dual = rho_c * (zs_c - zp_c)
            primal_error = _inf_norm(D * (xs_c - zs_c))
            dual_error = _inf_norm(D * s_dual)
            x_norm = _inf_norm(D * xs_c)
            z_norm = _inf_norm(D * zs_c)
            y_norm = _inf_norm(rho_c * D * us_c)
            # Qx from the KKT identity (Q + rho I) x + A^T nu = r instead of
            # a (B, n, n) GEMV; it only enters a tolerance normalizer.
            Qx = last_r[:, :n] - rho_c * xs_c
            if As is not None:
                Qx = Qx - lin._mv(As_u.mT, nu_s)
            Qx_norm = _inf_norm(Qx / D)

            tolp_norm = torch.clamp(torch.maximum(x_norm, z_norm),
                                    min=_ZERO_CLAMP)
            tol_primal = eps_abs + eps_rel * tolp_norm
            told_norm = torch.clamp(
                torch.maximum(torch.maximum(y_norm, Qx_norm), p_norm),
                min=_ZERO_CLAMP)
            tol_dual = eps_abs + eps_rel * told_norm
            is_optimal = (primal_error < tol_primal) & (dual_error < tol_dual)

            # OSQP-style primal-infeasibility certificate (Banjac et al.
            # 2019): over a check interval the dual differences of an
            # infeasible problem converge to a separating functional,
            # A^T d_nu + d_lambda -> 0 with negative support.  Unscaled.
            u_chk_prev, u_chk = u_chk, us_c
            if config.detect_infeasibility:
                du = us_c - u_chk_prev
                dlam_us = rho_c * du / D
                if As is not None:
                    dnu = nu_s - nu_chk
                    cert = (lin._mv(As_u.mT, dnu) + rho_c * du) / D
                    dual_scale = torch.maximum(_inf_norm(dlam_us),
                                               _inf_norm(dnu * E))
                    support = (bs * dnu).sum(dim=-1)
                    nu_chk = nu_s
                else:
                    cert = dlam_us
                    dual_scale = _inf_norm(dlam_us)
                    support = torch.zeros((B,), dtype=dtype, device=device)
                dup = rho_c * torch.clamp(du, min=0.0)
                dun = rho_c * torch.clamp(du, max=0.0)
                # An infinite bound has zero support only where the
                # direction has no mass (0 * inf would be NaN).
                sup_ub = torch.where(
                    torch.isfinite(ubs), ubs * dup,
                    torch.where(dup > 0, math.inf, 0.0).to(dtype))
                sup_lb = torch.where(
                    torch.isfinite(lbs), lbs * dun,
                    torch.where(dun < 0, math.inf, 0.0).to(dtype))
                support = support + (sup_ub + sup_lb).sum(dim=-1)
                pinf_el = ((_inf_norm(cert) <= eps_inf * dual_scale)
                           & (support <= -eps_inf * dual_scale)
                           & (dual_scale > _ZERO_CLAMP))
                pinf = pinf | (pinf_el & ~is_optimal)

            it += n_inner
            if K:
                trace[n_chk % K] = torch.stack([
                    torch.tensor(float(it), dtype=dtype, device=device),
                    primal_error.amax(), dual_error.amax()])
                n_chk += 1

            if config.adaptive_rho:
                # Per-element gate: an element's rho moves only when its own
                # primal/dual ratio is outside the band, inside the window.
                do_rho_update = ((primal_error > torch.clamp(tol_primal,
                                                             min=thr))
                                 | (dual_error > torch.clamp(tol_dual,
                                                             min=thr)))
                ratio = rho_ratio()
                el_outside = (ratio > tol_r) | (ratio < 1.0 / tol_r)
                window = (it >= adaptive_interval
                          and it < config.adaptive_rho_max_iter
                          and (it % adaptive_interval) < cs)
                rho_pending = (do_rho_update & el_outside if window
                               else torch.zeros_like(rho_pending))

            if config.verbose:
                print(f"iter={it}  primal={primal_error.amax().item():.3e}"
                      f"  dual={dual_error.amax().item():.3e}")
            done, pending = flags()

        if not config.adaptive_rho or it >= max_iters or done:
            break
        # The inner loop stopped on a pending rho update: rescale the
        # pending elements' rho and refactorize.
        rho_new = torch.where(rho_pending, rho * rho_ratio(), rho)
        rho = torch.clamp(rho_new, config.rho_min, config.rho_max)
        factors, q = factorize(rho)
        rho_pending = torch.zeros_like(rho_pending)
        pending = False

    # --- unscale and extract the duals.
    nus = None
    if As is not None:
        nus = lin._mv(factors.Sinv, lin._mv(factors.W.mT, last_r) - bs) * E
    xs, zs, us = x[:, :n], z[:, :n], u[:, :n]
    rho_c = rho[..., None]
    lam_lo_s = torch.clamp(-us * rho_c, min=0.0)
    lam_hi_s = torch.clamp(us * rho_c, min=0.0)

    trace_out = None
    if K:
        # Un-rotate the ring so rows are chronological (oldest first).
        shift = 0 if n_chk <= K else n_chk % K
        trace_out = torch.roll(trace, -shift, dims=0)

    return BoxQPSolution(
        x=D * xs, z=D * zs, u=us / D,
        lams=torch.cat([lam_lo_s / D, lam_hi_s / D], dim=-1),
        nus=nus, rho=rho, iterations=it,
        primal_residual=primal_error, dual_residual=dual_error,
        converged=is_optimal, primal_infeasible=pinf,
        residual_trace=trace_out)
