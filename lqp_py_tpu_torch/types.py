"""Solution objects returned by the solvers (counterpart of
``lqp_py_tpu.types``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class BoxQPSolution:
    """Batched box-QP solution.

    Vector fields are ``(n_batch, n)`` (squeezed layout).  ``iterations``
    is a Python ``int``: the solver's loop runs on the host, so the count
    is known there without a device read.
    """

    x: torch.Tensor                     # primal solution
    z: torch.Tensor                     # auxiliary (projected) primal
    u: torch.Tensor                     # scaled dual of the box constraint
    lams: torch.Tensor                  # (n_batch, 2n): [lambda_lb; lambda_ub]
    nus: Optional[torch.Tensor]         # (n_batch, n_eq) equality duals, or None
    rho: torch.Tensor                   # (n_batch,) final ADMM penalty
    iterations: int                     # iterations executed
    primal_residual: torch.Tensor       # (n_batch,) final unscaled primal residual
    dual_residual: torch.Tensor         # (n_batch,) final unscaled dual residual
    converged: torch.Tensor             # (n_batch,) bool
    #: (n_batch,) bool — an OSQP-style primal-infeasibility certificate was
    #: found (Banjac et al. 2019).
    primal_infeasible: Optional[torch.Tensor] = None
    #: (K, 3) ``[iteration, max primal, max dual]`` rows of the last K
    #: residual checks, oldest first (config.residual_trace = K > 0); rows
    #: never written hold iteration -1.  None when off.
    residual_trace: Optional[torch.Tensor] = None
    #: (n_batch,) bool — the polished point was accepted for this element
    #: (config.polish); None when polish is off.  The JAX package does not
    #: return this mask.
    polished: Optional[torch.Tensor] = None


@dataclasses.dataclass
class QPSolution:
    """Batched general-QP solution (equality and linear inequality
    constraints); ``iterations`` is a Python ``int``, as in
    ``BoxQPSolution``."""

    x: torch.Tensor
    lams: torch.Tensor                  # (n_batch, n_ineq) duals >= 0
    slacks: torch.Tensor                # (n_batch, n_ineq) h - Gx >= 0
    nus: Optional[torch.Tensor]         # (n_batch, n_eq) equality duals
    iterations: int
    primal_residual: torch.Tensor       # (n_batch,)
    dual_residual: torch.Tensor         # (n_batch,)
    converged: torch.Tensor             # (n_batch,) bool
    #: (n_batch,) bool infeasibility certificate; None from the interior
    #: point.
    primal_infeasible: Optional[torch.Tensor] = None


@dataclasses.dataclass
class EqQPSolution:
    """Solution of an equality-constrained (or unconstrained) QP."""

    x: torch.Tensor
    nus: Optional[torch.Tensor]


def as_vector(v, name="input"):
    """Canonicalize ``(B, n, 1)`` or ``(B, n)`` to ``(B, n)``."""
    if v is None:
        return None
    v = torch.as_tensor(v)
    if v.ndim == 3:
        if v.shape[-1] != 1:
            raise ValueError(f"{name}: expected trailing dim 1, got "
                             f"{tuple(v.shape)}")
        return v[..., 0]
    if v.ndim == 2:
        return v
    raise ValueError(f"{name}: expected rank 2 or 3, got shape "
                     f"{tuple(v.shape)}")


def like_layout(v, template):
    """Return ``v (B, n)`` in the same layout as ``template``."""
    if template is not None and template.ndim == 3:
        return v[..., None]
    return v
