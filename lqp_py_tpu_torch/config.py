"""Solver configuration, field for field the same as ``lqp_py_tpu.config``.

``BoxQPConfig`` and ``OptNetConfig`` keep the JAX package's field names,
defaults and construction checks, so one configuration means the same solve
in both packages (tests/test_torch_package.py holds the two together).  The
reasoning behind each default is documented on the JAX side
(lqp_py_tpu/config.py).  Every field of ``BoxQPConfig`` is ported: the
forward solve (with ``use_pallas_step``, ``polish``, ``acceleration`` and
``kkt_solver``), both implicit backward modes (``backward`` =
'fixed_point' or 'kkt', ``backward_reg``) and the unrolled one (``unroll``,
``unroll_iters``).  ``OptNetConfig`` drives both interior-point solvers
(models/box_ip.py, models/optnet.py), ``GenQPConfig`` the
general-inequality splitting solver (models/genqp.py); ``scs_control``
maps the reference's SCS knob names onto it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def _check_interval_default(n_x: int) -> int:
    # Reference heuristic max(round(sqrt(n_x)/10)*10, 1), capped at 4: a
    # check is cheap next to an iteration, and the expected overshoot past
    # convergence is cs/2 iterations.
    return max(min(round(math.sqrt(n_x) / 10) * 10, 4), 1)


def _check_acceleration(m: int) -> None:
    if m < 0:
        raise ValueError(
            f"acceleration must be >= 0 (type-II AA window size), got {m}; "
            f"SCS's negative acceleration_lookback selects type-I AA, which "
            f"is not implemented — pass the window size itself")


@dataclasses.dataclass(frozen=True)
class BoxQPConfig:
    """Configuration for the batched box-QP ADMM solver."""

    max_iters: int = 10_000
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    #: Residual-check interval; ``None`` -> ``_check_interval_default``.
    check_solved: Optional[int] = None
    #: ADMM penalty; ``None`` -> per-element auto:
    #: rho_scale * ||D Q D||_F / sqrt(n_x).
    rho: Optional[float] = None
    rho_scale: float = 0.5
    rho_min: float = 1e-6
    rho_max: float = 1e6
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0
    #: First adaptive-rho update / update spacing, in iterations.
    adaptive_rho_iter: int = 25
    adaptive_rho_max_iter: int = 1000
    adaptive_rho_threshold: float = 1e-5
    #: Over-relaxation (x_hat = alpha*x + (1-alpha)*z); 1.0 is the plain
    #: iteration.
    alpha: float = 1.6
    verbose: bool = False
    scale: bool = True
    #: Scaling blend factor; ``None`` -> per-element auto from D quantiles.
    beta: Optional[float] = None
    unroll: bool = False
    #: Solve with 0.5*(Q + Q^T); turn off for exactly symmetric inputs to
    #: save a full (B, n, n) pass.
    symmetrize: bool = True
    #: Backward mode: 'fixed_point' | 'kkt' (unroll=True uses autodiff).
    backward: str = "fixed_point"
    #: KKT solve strategy: 'inverse' (one GEMV against the reduced KKT
    #: inverse per iteration) or 'cholesky' (triangular solves).
    kkt_solver: str = "inverse"
    unroll_iters: Optional[int] = None
    backward_reg: float = 1e-8
    polish: bool = False
    detect_infeasibility: bool = True
    eps_infeas: float = 1e-5
    #: K > 0 returns the last K residual checks as ``[iteration, max
    #: primal, max dual]`` rows in ``solution.residual_trace``.
    residual_trace: int = 0
    use_pallas_step: bool = False
    acceleration: int = 0
    aa_safeguard: float = 2.0
    aa_reg: float = 1e-8
    aa_max_weight: float = 1e3

    def __post_init__(self):
        if not (0.0 < self.alpha < 2.0):
            raise ValueError(
                f"alpha must be in (0, 2) for ADMM convergence, got "
                f"{self.alpha}")
        if self.acceleration and self.use_pallas_step:
            raise ValueError(
                "acceleration requires use_pallas_step=False (the fused "
                "kernel's in-VMEM iteration cannot carry the AA history)")
        if self.acceleration and self.unroll:
            raise ValueError(
                "acceleration is not implemented for the unrolled "
                "(differentiate-through-iterations) path; use the implicit "
                "backward modes with acceleration, or unroll without it")
        _check_acceleration(self.acceleration)
        if self.polish and self.unroll:
            raise ValueError(
                "polish is not implemented for the unrolled "
                "(differentiate-through-iterations) path — it returns the "
                "bare iterate; use the implicit backward modes with polish")

    def resolved_check_interval(self, n_x: int) -> int:
        cs = self.check_solved
        if cs is None:
            cs = _check_interval_default(n_x)
        return max(int(cs), 1)

    def resolved_adaptive_interval(self, n_x: int) -> int:
        # The adaptive-rho interval is a multiple of the check interval.
        cs = self.resolved_check_interval(n_x)
        it = round(self.adaptive_rho_iter / cs) * cs
        return max(it, 1)


@dataclasses.dataclass(frozen=True)
class OptNetConfig:
    """Configuration for the batched interior-point (OptNet-style) solvers."""

    max_iters: int = 10
    tol: float = 1e-3
    #: Accepted for the JAX package's signature; the interior point tests
    #: convergence every iteration.
    check_solved: int = 1
    verbose: bool = False
    #: Stopping test across the batch: 'max' runs until every element
    #: has converged, 'mean' until the batch-mean residual is below tol.
    reduce: str = "max"
    symmetrize: bool = True
    int_reg: float = 1e-6
    #: Per-iteration factorization of the general solver: 'schur' (the
    #: ni x ni inequality Schur block), 'condensed' (the n x n
    #: ``Q + G' diag(d) G``) or 'auto' (condensed iff n_ineq > n_x).
    factor: str = "auto"
    #: Iterative-refinement steps on each condensed KKT solve.
    refine_steps: int = 0
    #: Active-set polish after the loop (two rounds, a third where round 2
    #: narrowly fails on some element), accepted per element.
    polish: bool = True


@dataclasses.dataclass(frozen=True)
class GenQPConfig:
    """Configuration for the batched general-inequality splitting solver:
    ``min 1/2 x'Qx + p'x  s.t.  Ax = b, Gx <= h``."""

    max_iters: int = 20_000
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    check_solved: int = 25
    #: Splitting penalty; ``None`` -> per-element auto:
    #: rho_scale * ||D Q D||_F / sqrt(n).
    rho: Optional[float] = None
    rho_scale: float = 0.3
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    symmetrize: bool = True
    #: Over-relaxation on the splitting variable (1.0 = plain iteration).
    alpha: float = 1.6
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0
    adaptive_rho_iter: int = 100
    adaptive_rho_max_iter: int = 4000
    adaptive_rho_threshold: float = 1e-5
    #: True moves each element's rho on its own ratio; False rescales every
    #: element (still masked by its own convergence gate) whenever any one
    #: is out of band, the reference's behaviour and the default here.
    adaptive_rho_per_element: bool = False
    verbose: bool = False
    scale: bool = True
    #: Backward mode: 'kkt' (active-set KKT implicit differentiation) or
    #: 'conic' (SCS-style projection-derivative implicit differentiation).
    backward: str = "kkt"
    detect_infeasibility: bool = True
    eps_infeas: float = 1e-5
    polish: bool = False
    #: Anderson-acceleration window on the (w, u) fixed point; 0 = off.
    acceleration: int = 0
    aa_safeguard: float = 2.0
    aa_reg: float = 1e-8
    aa_max_weight: float = 1e3

    def __post_init__(self):
        _check_acceleration(self.acceleration)


def box_qp_control(**kwargs) -> BoxQPConfig:
    """Dict-style constructor mirroring the reference's ``box_qp_control``.

    Unknown keys raise immediately instead of being silently ignored.
    """
    return BoxQPConfig(**kwargs)


def optnet_control(**kwargs) -> OptNetConfig:
    """Dict-style constructor of an ``OptNetConfig``."""
    return OptNetConfig(**kwargs)


def genqp_control(**kwargs) -> GenQPConfig:
    """Dict-style constructor of a ``GenQPConfig``."""
    return GenQPConfig(**kwargs)


#: The reference's ``scs_control`` knobs with no counterpart in the batched
#: lock-step solver: the sequential C solver's plumbing, per-k Anderson
#: scheduling and wall-clock limits.
_SCS_UNSUPPORTED = {
    "use_indirect", "mkl", "gpu",
    "acceleration_interval", "time_limit_secs", "write_data_filename",
    "log_csv_filename",
}


def scs_control(**kwargs) -> GenQPConfig:
    """A ``GenQPConfig`` from the reference's ``scs_control`` knob names.

    normalize -> scale; scale -> rho (SCS's dual scale is the splitting
    penalty); adaptive_scale -> adaptive_rho; rho_x -> sigma;
    acceleration_lookback -> acceleration (its magnitude: the batched
    acceleration is type-II); eps_infeas sets the certificate tolerance and
    turns detection on; alpha, eps_abs/eps_rel, max_iters and verbose pass
    through.  Knobs in ``_SCS_UNSUPPORTED`` raise unless
    ``ignore_unsupported=True``, which drops them.
    """
    kwargs = dict(kwargs)
    ignore = kwargs.pop("ignore_unsupported", False)
    unsupported = sorted(set(kwargs) & _SCS_UNSUPPORTED)
    if unsupported and not ignore:
        raise ValueError(
            f"scs_control knobs {unsupported} have no counterpart in "
            f"lqp_py_tpu_torch's batched splitting solver (see PARITY.md); "
            f"pass ignore_unsupported=True to drop them")
    for k in _SCS_UNSUPPORTED:
        kwargs.pop(k, None)
    if "scale" in kwargs:
        kwargs.setdefault("rho", float(kwargs.pop("scale")))
    if "acceleration_lookback" in kwargs:
        kwargs.setdefault(
            "acceleration", abs(int(kwargs.pop("acceleration_lookback"))))
    if "eps_infeas" in kwargs:
        kwargs.setdefault("detect_infeasibility", True)
        kwargs["eps_infeas"] = float(kwargs["eps_infeas"])
    rename = {"normalize": "scale", "adaptive_scale": "adaptive_rho",
              "rho_x": "sigma"}
    return GenQPConfig(**{rename.get(k, k): v for k, v in kwargs.items()})
