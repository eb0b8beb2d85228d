"""Batched box-QP ADMM solver (counterpart of ``lqp_py_tpu.models.box_qp``).

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
which stay frozen until the batch stops.  ``kkt_solver='cholesky'`` applies
the KKT inverse by triangular solves (the early-exit step is off there, as
in the JAX package); ``acceleration=m`` adds safeguarded Anderson steps on
``v = [z; u]`` (``ops/anderson.py``); ``polish=True`` re-solves each
element on its detected active set (``models/_polish.py``) and keeps the
polished point where it is no worse.  Where the JAX package traces a
``lax.while_loop``, this module runs a Python loop: the ``cs`` iterations
between two residual checks are queued on the device, and each check reads
two flags back to the host ("every element done", "some rho pending"),
one synchronization per check.

``solve_box_qp_unrolled`` is the differentiable-by-unrolling solve: a
fixed number of iterations recorded by autograd, each KKT solve
differentiated through cached factors (``kkt_solve_cached``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models._polish import box_penalty_polish
from lqp_py_tpu_torch.ops import anderson, collective
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops import scaling as sca
from lqp_py_tpu_torch.ops.kernels import admm_step
from lqp_py_tpu_torch.ops.kernels.admm_step import fused_admm_step
from lqp_py_tpu_torch.ops.operator import DENSE
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import BoxQPSolution, as_vector
from lqp_py_tpu_torch.utils.profiling import span

_ZERO_CLAMP = 1e-16


def _inf_norm(v):
    return v.abs().amax(dim=-1)


def _any_finite(lb, ub):
    """Whether any bound anywhere in the batch is finite (a 0-d bool
    tensor); global over the batch group of ``ops/collective.py``."""
    return collective.batch_any((lb.amax() > -math.inf)
                                | (ub.amin() < math.inf))


def _canonical(Q, p, A, b, lb, ub, config):
    """Symmetrize Q (``config.symmetrize``) and bring every input to (B, n)
    / (B, m) layout on Q's device and dtype, with infinite bounds where
    none are given."""
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
    return Q, p, A, b, lb, ub


def _prep(Q, p, A, b, lb, ub, config, pad: int = 0):
    """The unfused preparation of the unrolled solve: canonical shapes, the
    unscaled p-norm, the scaled problem (``scale_problem`` or
    ``identity_scaling``, differentiable in every input) and rho.
    Returns ``(ScaledProblem, p_norm, rho)``."""
    with span("lqp.scale"):
        Q, p, A, b, lb, ub = _canonical(Q, p, A, b, lb, ub, config)
        B, n = p.shape
        p_norm = _inf_norm(p)
        if config.scale:
            sp = sca.scale_problem(Q, p, A, b, lb, ub, beta=config.beta,
                                   pad=pad)
        else:
            sp = sca.identity_scaling(Q, p, A, b, lb, ub, pad=pad)
        if config.rho is None:
            # The identity pad block contributes exactly ``pad`` to
            # sum(Q^2).
            q_fro = torch.sqrt(torch.clamp(
                (sp.Q * sp.Q).sum(dim=(-1, -2)) - pad, min=0.0))
            rho = torch.clamp(config.rho_scale * q_fro / math.sqrt(n),
                              config.rho_min, config.rho_max)
        else:
            rho = torch.full((B,), float(config.rho), dtype=p.dtype,
                             device=p.device)
        # With no finite bound anywhere in the batch rho is forced to 0.
        any_ineq = _any_finite(lb, ub)
        return sp, p_norm, torch.where(any_ineq, rho,
                                       torch.zeros_like(rho))


def _prep_h(Q, p, A, b, lb, ub, config, pad: int = 0):
    """Canonicalize shapes, take the unscaled p-norm, and build the scaled,
    lane-padded factorization operand ``H = D Q D + rho I`` in one pass
    (``scale_problem_h``).  Every input moves to Q's device and dtype."""
    with span("lqp.scale"):
        Q, p, A, b, lb, ub = _canonical(Q, p, A, b, lb, ub, config)
        kw = dict(dtype=Q.dtype, device=Q.device)
        B, n = p.shape

        # The dual tolerance uses the unscaled p-norm.
        p_norm = _inf_norm(p)
        # With no finite bound anywhere in the batch the box projection is
        # the identity and rho is forced to 0: ADMM then converges in one
        # step.
        any_ineq = _any_finite(lb, ub)

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


def _mode(config: BoxQPConfig) -> str:
    mode = config.kkt_solver
    if mode not in ("inverse", "cholesky"):
        raise ValueError(f"unknown kkt_solver {mode!r}")
    return mode


#: Lane alignment of the variable axis.  The port keeps the JAX package's
#: padding (128, or 256 for the early-exit step) so that its iterates match
#: step for step; padded coordinates are inert (p = 0, bounds +/-inf,
#: identity block in H).  The CUDA kernels take any n.
_ALIGN = 128


def _padded_n(config: BoxQPConfig, n: int, mode: str):
    """``(n_pad, use_pallas)``: the early-exit step runs in inverse mode
    only, and is silently off in Cholesky mode, as in the JAX package."""
    use_pallas = bool(config.use_pallas_step) and mode == "inverse"
    align = 256 if use_pallas else _ALIGN
    return -(-n // align) * align, use_pallas


def _pad_identity(M, pad):
    """Pad (B, n, n) to (B, n+pad, n+pad) with an identity block (valid for
    SPD matrices and their lower Cholesky factors alike)."""
    n = M.shape[-1]
    out = F.pad(M, (0, pad, 0, pad))
    out.diagonal(dim1=-2, dim2=-1)[:, n:] = 1.0
    return out


def _pad_factors(f: lin.KKTFactors, pad: int) -> lin.KKTFactors:
    """Resize cached KKT factors to the solve's aligned size.

    pad > 0: zero-pad P/Hinv and W/WS's rows (the padded coordinates' r is
    identically 0), and pad L with an identity block.  pad < 0: slice,
    which is exact because the factors were built from an identity-padded
    H with zero-padded A columns: the padded block decouples, so P, Hinv,
    L and W restrict to the leading block.
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

    L = (opt(nn, f.L) if pad < 0 else
         opt(lambda a: _pad_identity(a, pad), f.L))
    return dataclasses.replace(f, P=opt(nn, f.P), Hinv=opt(nn, f.Hinv),
                               W=opt(nm, f.W), WS=opt(nm, f.WS), L=L)


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
    nv = as_vector(p, "p").shape[-1]
    n_pad, _ = _padded_n(config, nv, _mode(config))
    sph, p_norm, rho0 = _prep_h(Q, p, A, b, lb, ub, config, pad=n_pad - nv)
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
    ``mode`` is the ``kkt_solver`` the factors were built for; a solve with
    another mode raises.
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
    mode: str = "inverse"


@solver_precision
def prepare_box_qp(Q, A=None, b=None, lb=None, ub=None,
                   config: BoxQPConfig = BoxQPConfig()) -> BoxQPPrepared:
    """Precompute everything that does not depend on ``p``: scaling,
    auto-rho, and the KKT factorization."""
    mode = _mode(config)
    Q = torch.as_tensor(Q)
    n = Q.shape[-1]
    p0 = Q.new_zeros(Q.shape[:-1])
    n_pad, use_pallas = _padded_n(config, n, mode)
    sph, _p_norm, rho0 = _prep_h(Q, p0, A, b, lb, ub, config, pad=n_pad - n)
    with span("lqp.factorize"):
        factors = lin.factorize_kkt(sph.H, None, sph.A, mode=mode,
                                    equilibrate=not config.scale,
                                    materialize_p=use_pallas)
    return BoxQPPrepared(H=sph.H, As=sph.A, bs=sph.b, lbs=sph.lb,
                         ubs=sph.ub, D=sph.D, E=sph.E, rho0=rho0,
                         factors=factors, mode=mode)


@solver_precision
def solve_box_qp_prepared(prep: BoxQPPrepared, p,
                          config: BoxQPConfig = BoxQPConfig(),
                          warm_start=None) -> BoxQPSolution:
    """Solve for a new cost vector ``p`` against a cached preparation."""
    if prep.mode != _mode(config):
        raise ValueError(
            f"BoxQPPrepared was built with kkt_solver={prep.mode!r} but the "
            f"solve config requests {config.kkt_solver!r}; re-run "
            f"prepare_box_qp with the matching config")
    pv = as_vector(p, "p").to(dtype=prep.H.dtype, device=prep.H.device)
    p_norm = _inf_norm(pv)
    ps = prep.D * pv
    return _solve_scaled(config, ps, prep.As, prep.bs, prep.lbs, prep.ubs,
                         prep.D, prep.E, p_norm, prep.rho0, prep.factors,
                         warm_start, H0=prep.H)


class _KKTOperator:
    """The ADMM loop's access to its reduced KKT operator: factorize the
    operand ``H0 = D Q D + rho0 I`` shifted to another rho, apply the
    factored inverse in the x-update (lock-step, or the early-exit GEMV on
    ``P``), multiply by ``A^T``, and hand the polish its operands.  This one
    holds the whole lane-padded operand; ``parallel/tp.py`` holds a column
    block of it and adds the collectives.

    ``H0`` (B, n_pad, n_pad) and ``As`` (B, m, n_pad) with zero pad
    columns; ``n`` is the unpadded size."""

    def __init__(self, H0, As, bs, rho0, n, mode, equilibrate, use_pallas):
        self.H0, self.As, self.bs, self.rho0 = H0, As, bs, rho0
        self.n, self.n_pad = n, H0.shape[-1]
        self.mode, self.equilibrate = mode, equilibrate
        self.use_pallas = use_pallas

    def factorize(self, rho=None) -> lin.KKTFactors:
        """Factors of ``H0`` shifted to ``rho`` (``None``: ``H0`` itself).
        Only the leading-n diagonal shifts: the pad block's identity stays
        put, so a downward rho move cannot push its pivots toward zero."""
        with span("lqp.factorize"):
            H = self.H0
            if rho is not None:
                H = H.clone()
                H.diagonal(dim1=-2, dim2=-1)[:, :self.n] += (
                    rho - self.rho0)[:, None]
            return lin.factorize_kkt(H, None, self.As, mode=self.mode,
                                     equilibrate=self.equilibrate,
                                     materialize_p=self.use_pallas)

    def step_constant(self, f: lin.KKTFactors):
        """``q`` of the x-update ``x = P r + q``."""
        op = lin.kkt_step_operator(f, self.bs)
        return (self.rho0.new_zeros((self.rho0.shape[0], self.n_pad))
                if op is None else op[1])

    def x_update(self, f: lin.KKTFactors, q, r):
        """x = P r + q where P is materialized, else x = Hinv r - WS (W^T r)
        + q: one dense GEMV and two rank-n_eq corrections.  Cholesky mode
        takes the triangular solves of kkt_apply."""
        if f.P is not None:
            return lin._mv(f.P, r) + q
        if f.Hinv is None:
            return lin.kkt_apply(f, r, self.bs)[0]
        y = lin._mv(f.Hinv, r)
        if f.W is not None:
            y = y - lin._mv(f.WS, lin._mv(f.W.mT, r))
        return y + q

    def gemv(self, P, r, x, converged):
        """The early-exit step's ``P r``, ``x`` where converged."""
        return admm_step.gemv_early_exit(P, r, x, converged)

    def at_mv(self, *vs):
        """``A^T v`` (B, n) for each (B, m) ``v``."""
        At = self.As[:, :, :self.n].mT
        return tuple(lin._mv(At, v) for v in vs)

    def polish_operands(self):
        """``(ops, Qs, As)`` of the polish: the scaled Q rebuilt from the
        factorization operand, as the JAX package does (it cancels on the
        diagonal in float32 when rho0 is near rho_max; kept for parity,
        ROADMAP's reference faults), and A without its pad columns."""
        n = self.n
        Qs = self.H0[:, :n, :n] - self.rho0[:, None, None] * torch.eye(
            n, dtype=self.H0.dtype, device=self.H0.device)
        return DENSE, Qs, None if self.As is None else self.As[:, :, :n]


def _solve_scaled(config, ps, As, bs, lbs, ubs, D, E, p_norm, rho0,
                  factors_in, warm_start, H0, kkt=None) -> BoxQPSolution:
    """The ADMM loop on an already-scaled problem.

    ``H0`` is the lane-padded factorization operand ``D Q D + rho0 I``;
    ``As`` arrives with zero pad columns.  ``factors_in`` are cached
    factors of ``H0`` (prepared solve) or None (factorize here).  A
    preparation made at another alignment than this solve's is resized:
    the identity pad is extended or sliced off.  ``kkt`` replaces the
    whole-operator ``_KKTOperator`` (``parallel/tp.py``'s column block)."""
    B, n = ps.shape
    dtype, device = ps.dtype, ps.device
    cs = config.resolved_check_interval(n)
    adaptive_interval = config.resolved_adaptive_interval(n)
    max_iters = int(config.max_iters)
    mode = _mode(config)
    if kkt is None:
        n_pad, use_pallas = _padded_n(config, n, mode)
        built = H0.shape[-1]
        if built < n_pad:
            H0 = _pad_identity(H0, n_pad - built)
            As = None if As is None else F.pad(As, (0, n_pad - built))
        elif built > n_pad:
            H0 = H0[:, :n_pad, :n_pad]
            As = None if As is None else As[:, :, :n_pad]
        kkt = _KKTOperator(H0, As, bs, rho0, n, mode,
                           equilibrate=not config.scale,
                           use_pallas=use_pallas)
    n_pad, use_pallas = kkt.n_pad, kkt.use_pallas
    pad = n_pad - n
    ps_p = F.pad(ps, (0, pad))
    lbs_p = F.pad(lbs, (0, pad), value=-math.inf)
    ubs_p = F.pad(ubs, (0, pad), value=math.inf)

    if factors_in is None:
        factors = kkt.factorize()
    else:
        factors = factors_in
        if use_pallas and factors.P is None:
            # Prepared without P but the early-exit step wants it: build it
            # from the cached pieces (one GEMM, no refactorization).
            factors = dataclasses.replace(
                factors, P=factors.Hinv if factors.W is None
                else factors.Hinv - factors.WS @ factors.W.mT)
        dense = next(a for a in (factors.P, factors.Hinv, factors.L)
                     if a is not None)
        if dense.shape[-1] != n_pad:
            factors = _pad_factors(factors, n_pad - dense.shape[-1])
    q = kkt.step_constant(factors)

    # Over-relaxation collapses to alpha = 1 when no bound is finite (rho
    # is 0 there and the plain iteration converges in one step).
    has_alpha = float(config.alpha) != 1.0
    alpha_t = torch.where(_any_finite(lbs, ubs),
                          torch.tensor(float(config.alpha), dtype=dtype,
                                       device=device),
                          torch.tensor(1.0, dtype=dtype, device=device))

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
    m_aa = int(config.acceleration)
    aa = (anderson.aa_init(B, m_aa, 2 * n_pad, dtype, device) if m_aa
          else None)

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

    def flags(maxima=()):
        """(every element optimal or infeasible, some rho pending), and the
        batch-wide maximum of each of ``maxima``: the one collective and
        device-to-host read of a residual check."""
        g = collective.batch_max(torch.stack(
            [(~(is_optimal | pinf)).any().to(dtype),
             rho_pending.any().to(dtype), *maxima]))
        positive = g[:2] > 0
        with span("lqp.check"):
            busy, pending = positive.tolist()
        return not busy, pending, g[2:]

    with span("lqp.loop"):
        done, pending, _ = flags()
        while True:
            # Inner loop: residual-check blocks until every element is done,
            # the iteration cap is hit, or some element's rho must update.
            while it < max_iters and not done and not pending:
                # The first check comes after a single iteration, then every
                # cs.
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
                            is_optimal, alpha=a, gemv=kkt.gemv)
                    # r now feeds the next iteration.  The r that produced x is
                    # rebuilt by inverting the (relaxed) dual update
                    # u = u_prev + (a x + (1 - a) z_prev - z); frozen elements
                    # keep the r that actually produced their x.
                    u_prev = u - (a * x + (1.0 - a) * z_prev - z)
                    last_r = torch.where(is_optimal[:, None], last_r,
                                         -ps_p + rho_c * (z_prev - u_prev))
                else:
                    for i in range(n_inner):
                        r = -ps_p + rho_c * (z - u)
                        x = kkt.x_update(factors, q, r)
                        z_prev = z
                        xh = (alpha_t * x + (1.0 - alpha_t) * z if has_alpha
                              else x)
                        z_new = torch.clamp(xh + u, lbs_p, ubs_p)
                        u_new = u + (xh - z_new)
                        if m_aa:
                            # A safeguarded Anderson step on v = [z; u]; padded
                            # coordinates stay 0 (every history column is 0
                            # there).
                            v_next, aa = anderson.aa_step(
                                aa, torch.cat([z, u], dim=-1),
                                torch.cat([z_new, u_new], dim=-1),
                                (it + i) % m_aa, hold=is_optimal,
                                safeguard=float(config.aa_safeguard),
                                reg=float(config.aa_reg),
                                max_weight=float(config.aa_max_weight))
                            z_new, u_new = v_next[:, :n_pad], v_next[:, n_pad:]
                        z, u = z_new, u_new
                    last_r = r
                xs_c, zs_c, us_c, zp_c = (v[:, :n] for v in (x, z, u, z_prev))

                # Equality duals implied by the current factored solve, and
                # A^T of them and of their change since the last check.
                nu_s = dnu = None
                if As is not None:
                    nu_s = lin._mv(factors.Sinv, lin._mv(factors.W.mT, last_r)
                                   - bs)
                    if config.detect_infeasibility:
                        dnu = nu_s - nu_chk
                        at_nu, at_dnu = kkt.at_mv(nu_s, dnu)
                    else:
                        at_nu, = kkt.at_mv(nu_s)

                # OSQP-style stopping test on unscaled residuals.
                s_dual = rho_c * (zs_c - zp_c)
                primal_error = _inf_norm(D * (xs_c - zs_c))
                dual_error = _inf_norm(D * s_dual)
                x_norm = _inf_norm(D * xs_c)
                z_norm = _inf_norm(D * zs_c)
                y_norm = _inf_norm(rho_c * D * us_c)
                # Qx from the KKT identity (Q + rho I) x + A^T nu = r instead
                # of a (B, n, n) GEMV; it only enters a tolerance normalizer.
                Qx = last_r[:, :n] - rho_c * xs_c
                if As is not None:
                    Qx = Qx - at_nu
                Qx_norm = _inf_norm(Qx / D)

                tolp_norm = torch.clamp(torch.maximum(x_norm, z_norm),
                                        min=_ZERO_CLAMP)
                tol_primal = eps_abs + eps_rel * tolp_norm
                told_norm = torch.clamp(
                    torch.maximum(torch.maximum(y_norm, Qx_norm), p_norm),
                    min=_ZERO_CLAMP)
                tol_dual = eps_abs + eps_rel * told_norm
                is_optimal = ((primal_error < tol_primal)
                              & (dual_error < tol_dual))

                # OSQP-style primal-infeasibility certificate (Banjac et al.
                # 2019): over a check interval the dual differences of an
                # infeasible problem converge to a separating functional,
                # A^T d_nu + d_lambda -> 0 with negative support.  Unscaled.
                u_chk_prev, u_chk = u_chk, us_c
                if config.detect_infeasibility:
                    du = us_c - u_chk_prev
                    dlam_us = rho_c * du / D
                    if As is not None:
                        cert = (at_dnu + rho_c * du) / D
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
                if config.adaptive_rho:
                    # Per-element gate: an element's rho moves only when its
                    # own primal/dual ratio is outside the band, inside the
                    # window.
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
                done, pending, maxima = flags(
                    (primal_error.amax(), dual_error.amax()) if K else ())
                if K:
                    trace[n_chk % K, 0] = float(it)
                    trace[n_chk % K, 1:] = maxima
                    n_chk += 1

            if not config.adaptive_rho or it >= max_iters or done:
                break
            # The inner loop stopped on a pending rho update: rescale the
            # pending elements' rho and refactorize.
            rho_new = torch.where(rho_pending, rho * rho_ratio(), rho)
            rho = torch.clamp(rho_new, config.rho_min, config.rho_max)
            factors = kkt.factorize(rho)
            q = kkt.step_constant(factors)
            if m_aa:
                # A rho update changes the fixed-point map: reset the updated
                # elements' history.
                aa = anderson.aa_reset_where(aa, rho_pending)
            rho_pending = torch.zeros_like(rho_pending)
            pending = False

    # --- unscale and extract the duals.
    nus = None
    if As is not None:
        nus = lin._mv(factors.Sinv, lin._mv(factors.W.mT, last_r) - bs) * E
    xs, zs, us = x[:, :n], z[:, :n], u[:, :n]
    if m_aa:
        # An accepted Anderson step is an affine combination of clipped
        # iterates (weights may be negative): project z back into the box.
        zs = torch.clamp(zs, lbs, ubs)
    rho_c = rho[..., None]
    lam_lo_s = torch.clamp(-us * rho_c, min=0.0)
    lam_hi_s = torch.clamp(us * rho_c, min=0.0)
    polished = None
    if config.polish:
        xs, zs, lam_lo_s, lam_hi_s, nus, polished = _polish(
            config, *kkt.polish_operands(), ps, bs, lbs, ubs, E, xs, zs, us,
            lam_lo_s, lam_hi_s, nus, pinf, m_aa)

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
        residual_trace=trace_out, polished=polished)


def _polish(config, ops, Qs_u, As_u, ps, bs, lbs, ubs, E, xs, zs, us,
            lam_lo_s, lam_hi_s, nus, pinf, m_aa):
    """Active-set polish of the final iterate on the scaled problem, taken
    per element where it is no less feasible than the iterate and its
    active multipliers are >= -eps_abs.  ``ops``, ``Qs_u``, ``As_u``: the
    KKT operator's ``polish_operands``.  Returns the (possibly polished)
    ``xs, zs, lam_lo_s, lam_hi_s, nus`` and the accepted mask."""
    dtype = xs.dtype
    # Proximity at tolerance scale (the scaled problem is equilibrated).
    prox = 10 * torch.tensor(config.eps_abs + config.eps_rel, dtype=dtype,
                              device=xs.device)
    if m_aa:
        # Anderson's u is an affine combination (sign noise on inactive
        # coordinates): detect by proximity alone, and pin a coordinate
        # detected on both sides of a narrow box at the iterate's z.
        act_lo = torch.isfinite(lbs) & (zs - lbs <= prox)
        act_hi = torch.isfinite(ubs) & (ubs - zs <= prox)
        both = act_lo & act_hi
        lbs_pol = torch.where(both, zs, lbs)
        ubs_pol = torch.where(both, zs, ubs)
    else:
        # Sign of u plus proximity: over-relaxation leaves small u on
        # barely-inactive coordinates.
        act_lo = (us < 0) & (zs - lbs <= prox)
        act_hi = (us > 0) & (ubs - zs <= prox)
        lbs_pol, ubs_pol = lbs, ubs
    pol = box_penalty_polish(Qs_u, ps, As_u, bs, lbs_pol, ubs_pol, act_lo,
                             act_hi, ops=ops)
    thr = torch.tensor(config.eps_abs, dtype=dtype, device=xs.device)

    def viol(xv):
        v_lo = torch.where(torch.isfinite(lbs), lbs - xv, -math.inf)
        v_hi = torch.where(torch.isfinite(ubs), xv - ubs, -math.inf)
        v = torch.maximum(v_lo, v_hi).amax(dim=-1)
        if As_u is not None:
            eq = ops.mv(As_u, xv) - bs
            v = torch.maximum(v, eq.abs().amax(dim=-1))
        return v

    lam_min = torch.minimum(pol.lam_lo, pol.lam_hi).amin(dim=-1)
    ok = ((viol(pol.x) <= torch.clamp(viol(xs), min=thr))
          & (lam_min >= -thr) & ~pinf)
    okc = ok[..., None]
    xs = torch.where(okc, pol.x, xs)
    zs = torch.where(okc, torch.clamp(pol.x, lbs, ubs), zs)
    lam_lo_s = torch.where(okc, torch.clamp(pol.lam_lo, min=0.0), lam_lo_s)
    lam_hi_s = torch.where(okc, torch.clamp(pol.lam_hi, min=0.0), lam_hi_s)
    if As_u is not None:
        nus = torch.where(okc, pol.y * E, nus)
    return xs, zs, lam_lo_s, lam_hi_s, nus, ok


@solver_precision
def solve_box_qp_unrolled(Q, p, A=None, b=None, lb=None, ub=None,
                          config: BoxQPConfig = BoxQPConfig()):
    """Differentiable-by-unrolling box-QP solve: autograd records every
    iteration.

    Runs ``config.unroll_iters`` iterations (default min(max_iters, 500))
    in blocks of the check interval ``cs``, with the batch-global OSQP
    convergence test after each block.  The factors are built once from
    the detached scaled problem; each iteration's KKT solve is
    differentiated through them (``kkt_solve_cached``), so gradients reach
    Q, p, A, b, lb and ub through the scaling as well.  rho is a constant
    of the graph and adaptive rho is off on this path, as in the JAX
    package.  Returns ``D * x`` only.

    The JAX package scans a fixed length and freezes every update once the
    batch is done; here the loop stops there instead.  A frozen step is the
    identity in value and in gradient, so x and every gradient are the
    same (tests/test_torch_unrolled.py holds the two lengths equal).
    """
    if config.acceleration:
        raise ValueError(
            "acceleration is not implemented for the unrolled solver; "
            "use solve_box_qp or acceleration=0")
    if config.polish:
        raise ValueError(
            "polish is not implemented for the unrolled solver; "
            "use solve_box_qp or polish=False")
    sp, p_norm, rho0 = _prep(Q, p, A, b, lb, ub, config)
    Qs, ps, As, bs, lbs, ubs, D, _E = sp
    B, n = ps.shape

    has_alpha = float(config.alpha) != 1.0
    alpha_t = torch.where(_any_finite(lbs, ubs),
                          torch.tensor(float(config.alpha), dtype=ps.dtype,
                                       device=ps.device),
                          torch.tensor(1.0, dtype=ps.dtype,
                                       device=ps.device))
    cs = config.resolved_check_interval(n)
    n_iters = config.unroll_iters
    if n_iters is None:
        n_iters = min(int(config.max_iters), 500)
    n_outer = max(-(-n_iters // cs), 1)
    eps_abs = max(float(config.eps_abs), 1e-12)
    eps_rel = max(float(config.eps_rel), 1e-12)

    # rho is a constant of the graph (the ADMM fixed point does not depend
    # on it), and the factors are built from detached operands: they get
    # no gradient.
    rho = rho0.detach()
    Qs_d, D_d, p_norm_d = Qs.detach(), D.detach(), p_norm.detach()
    with span("lqp.factorize"):
        factors = lin.factorize_kkt(Qs_d, rho, None if As is None
                                    else As.detach(), mode=_mode(config))
    rho_c = rho[..., None]

    x = z = u = torch.zeros((B, n), dtype=ps.dtype, device=ps.device)
    for _ in range(n_outer):
        for _ in range(cs):
            r = -ps + rho_c * (z - u)
            x, _nu = lin.kkt_solve_cached(factors, Qs, As, r, bs)
            xh = alpha_t * x + (1.0 - alpha_t) * z if has_alpha else x
            z_last = z
            # clip as maximum then minimum: ties split the gradient as
            # jnp.clip's do.
            z = torch.minimum(torch.maximum(xh + u, lbs), ubs)
            u = u + (xh - z)
        with torch.no_grad():
            xs, zs, us, zps = (v.detach() for v in (x, z, u, z_last))
            primal_error = _inf_norm(D_d * (xs - zs))
            dual_error = _inf_norm(D_d * (rho_c * (zs - zps)))
            x_norm = _inf_norm(D_d * xs)
            z_norm = _inf_norm(D_d * zs)
            y_norm = _inf_norm(rho_c * D_d * us)
            Qx_norm = _inf_norm(lin._mv(Qs_d, xs) / D_d)
            tolp = eps_abs + eps_rel * torch.clamp(
                torch.maximum(x_norm, z_norm), min=_ZERO_CLAMP)
            told = eps_abs + eps_rel * torch.clamp(
                torch.maximum(torch.maximum(y_norm, Qx_norm), p_norm_d),
                min=_ZERO_CLAMP)
            busy = collective.batch_any(
                (~((primal_error < tolp) & (dual_error < told))).any())
        if not bool(busy):
            break
    return D * x
