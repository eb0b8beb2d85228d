"""State carried across from numpy, and so from the JAX package.

The state is problem data (box or general inequalities), a
``BoxQPPrepared`` (scaled operand, scaled constraints, scaling vectors, rho0
and the KKT factors) or a ``GenQPPrepared``, a warm-start ``BoxQPSolution``, an interior-point
``QPSolution`` and its Schur-mode ``IPFactors`` (the backward's residual
set), and the weights of the Experiment-2 models (``LinearQP`` and
``LinearBoxQP``).  These functions take it as numpy
arrays — for a JAX object, the ``np.asarray`` of each of its fields, made
by the caller — and return the port's tensors and objects on ``device``,
the card unless the caller names another.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models.box_qp import BoxQPPrepared
from lqp_py_tpu_torch.models.genqp import GenQPPrepared
from lqp_py_tpu_torch.models.optnet import IPFactors
from lqp_py_tpu_torch.models.train import LinearQP
from lqp_py_tpu_torch.nn import LinearBoxQP
from lqp_py_tpu_torch.ops.linalg import KKTFactors
from lqp_py_tpu_torch.types import BoxQPSolution, QPSolution
from lqp_py_tpu_torch.utils.generators import QPData

CUDA = torch.device("cuda")


def _t(a, device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def problem_from_numpy(Q, p, A=None, b=None, lb=None, ub=None, *,
                       device=CUDA, dtype: Optional[torch.dtype] = None
                       ) -> QPData:
    """Problem data as tensors on ``device`` (in ``dtype`` if given, else
    in each array's own)."""
    return QPData(*(_t(a, device, dtype) for a in (Q, p, A, b, lb, ub)))


def gen_problem_from_numpy(Q, p, A=None, b=None, G=None, h=None, *,
                           device=CUDA, dtype: Optional[torch.dtype] = None):
    """General-inequality problem data ``(Q, p, A, b, G, h)`` as tensors on
    ``device`` (in ``dtype`` if given, else in each array's own)."""
    return tuple(_t(a, device, dtype) for a in (Q, p, A, b, G, h))


def _factors_from_numpy(f: Mapping, device) -> KKTFactors:
    return KKTFactors(**{k: _t(f.get(k), device) for k in (
        "Hinv", "W", "Sinv", "WS", "P", "L")})


def prepared_from_numpy(d: Mapping, device=CUDA) -> BoxQPPrepared:
    """A ``BoxQPPrepared`` from the fields of one (``H``, ``As``, ``bs``,
    ``lbs``, ``ubs``, ``D``, ``E``, ``rho0``, ``mode`` ('inverse' if
    absent), and ``factors`` as a mapping of ``KKTFactors`` fields: ``L``
    in Cholesky mode)."""
    return BoxQPPrepared(mode=d.get("mode", "inverse"),
        H=_t(d["H"], device), As=_t(d.get("As"), device),
        bs=_t(d.get("bs"), device), lbs=_t(d["lbs"], device),
        ubs=_t(d["ubs"], device), D=_t(d["D"], device),
        E=_t(d.get("E"), device), rho0=_t(d["rho0"], device),
        factors=_factors_from_numpy(d["factors"], device))


def gen_prepared_from_numpy(d: Mapping, device=CUDA) -> GenQPPrepared:
    """A ``GenQPPrepared`` from the fields of one (``Qs``, ``Gs``, ``hs``,
    ``D``, ``EG``, ``rho0``, ``GtG``, ``As``, ``bs`` and ``EA`` where there
    are equality rows, ``factors`` as a mapping of ``KKTFactors`` fields,
    and ``key``, the tuple of config fields, () if absent)."""
    return GenQPPrepared(
        **{k: _t(d.get(k), device) for k in (
            "Qs", "As", "bs", "Gs", "hs", "D", "EG", "EA", "rho0", "GtG")},
        factors=_factors_from_numpy(d["factors"], device),
        key=tuple(d.get("key", ())))


def solution_from_numpy(d: Mapping, device=CUDA) -> BoxQPSolution:
    """A ``BoxQPSolution`` from the fields of one (``iterations`` becomes a
    Python int).  A polished solution's ``lams`` and ``nus`` are the
    polished ones; ``polished``, the port's accepted mask, is carried
    where given."""
    return BoxQPSolution(
        x=_t(d["x"], device), z=_t(d["z"], device), u=_t(d["u"], device),
        lams=_t(d["lams"], device), nus=_t(d.get("nus"), device),
        rho=_t(d["rho"], device), iterations=int(d["iterations"]),
        primal_residual=_t(d["primal_residual"], device),
        dual_residual=_t(d["dual_residual"], device),
        converged=_t(d["converged"], device),
        primal_infeasible=_t(d.get("primal_infeasible"), device),
        residual_trace=_t(d.get("residual_trace"), device),
        polished=_t(d.get("polished"), device))


def qp_solution_from_numpy(d: Mapping, device=CUDA) -> QPSolution:
    """A ``QPSolution`` from the fields of one (``iterations`` becomes a
    Python int)."""
    return QPSolution(
        x=_t(d["x"], device), lams=_t(d["lams"], device),
        slacks=_t(d["slacks"], device), nus=_t(d.get("nus"), device),
        iterations=int(d["iterations"]),
        primal_residual=_t(d["primal_residual"], device),
        dual_residual=_t(d["dual_residual"], device),
        converged=_t(d["converged"], device),
        primal_infeasible=_t(d.get("primal_infeasible"), device))


def ip_factors_from_numpy(f: Mapping, device=CUDA) -> IPFactors:
    """Schur-mode ``IPFactors`` from their fields (``Qinv``, ``Rt``, and
    ``S11inv`` and ``T`` where there are equality constraints)."""
    return IPFactors(**{k: _t(f.get(k), device)
                        for k in IPFactors._fields})


def linear_qp_from_numpy(params, device=CUDA,
                         dtype: Optional[torch.dtype] = None) -> LinearQP:
    """A ``LinearQP`` from a ``LinearQPParams`` of numpy arrays (``W``
    (n_features, n_x) and ``bias`` (n_x,), the same layout)."""
    return LinearQP(_t(params.W, device, dtype), _t(params.bias, device,
                                                    dtype))


def linear_box_qp_from_flax(params: Mapping,
                            config: BoxQPConfig = BoxQPConfig(),
                            device=CUDA, dtype: Optional[torch.dtype] = None
                            ) -> LinearBoxQP:
    """A ``LinearBoxQP`` from the flax parameters of the JAX package's
    ``LinearBoxQP`` as numpy arrays, ``{"cost_head": {"kernel", "bias"}}``.
    The Dense kernel is (n_features, n_x); ``nn.Linear.weight`` is its
    transpose."""
    kernel = _t(params["cost_head"]["kernel"], device, dtype)
    bias = _t(params["cost_head"]["bias"], device, dtype)
    model = LinearBoxQP(kernel.shape[0], kernel.shape[1], config=config,
                        device=device, dtype=kernel.dtype)
    with torch.no_grad():
        model.cost_head.weight.copy_(kernel.T)
        model.cost_head.bias.copy_(bias)
    return model
