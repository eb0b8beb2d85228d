"""Differentiable box-QP layer (counterpart of ``lqp_py_tpu.models.layers``).

- ``boxqp(...)``: a ``torch.autograd.Function`` around the forward solve
  with the implicit fixed-point or KKT backward (``config.backward``), or,
  with ``config.unroll``, the unrolled solve under plain autograd.
- ``BoxQPLayer``: an ``nn.Module`` holding the config.
- ``BoxQP``: the stateful solve/update wrapper (cached preparation, p-only
  updates keep it, optional warm starts).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models import box_qp_grad as grads
from lqp_py_tpu_torch.models._stateful import StatefulQP
from lqp_py_tpu_torch.models.box_qp import (prepare_box_qp, solve_box_qp,
                                            solve_box_qp_prepared,
                                            solve_box_qp_unrolled)
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.types import as_vector, like_layout


@solver_precision
def _boxqp_bwd(config: BoxQPConfig, res, dl_dz, want_dQ=True, want_dA=True):
    """The implicit VJP of ``boxqp`` from its saved residual set:
    (dQ, dp, dA, db, dlb, dub), None where the input was None or the
    outer product is not wanted."""
    x, u, lams, nus, Q, A, lb, ub, rho, (lb_none, ub_none) = res
    if lb is None:
        lb = torch.full_like(x, -math.inf)
    if ub is None:
        ub = torch.full_like(x, math.inf)
    if config.backward == "kkt":
        dQ, dp, dA, db, dlb, dub = grads.box_qp_grad_kkt(
            dl_dz, x=x, lams=lams, nus=nus, Q=Q, A=A, lb=lb, ub=ub,
            want_dQ=want_dQ, want_dA=want_dA)
    elif config.backward == "fixed_point":
        dQ, dp, dA, db, dlb, dub = grads.box_qp_grad_fixed_point(
            dl_dz, x=x, u=u, lams=lams, nus=nus, Q=Q, A=A, lb=lb, ub=ub,
            rho=rho, reg=config.backward_reg, want_dQ=want_dQ,
            want_dA=want_dA)
    else:
        raise ValueError(f"unknown backward mode {config.backward!r}")
    if A is None:
        dA, db = None, None
    return (dQ, dp, dA, db, None if lb_none else dlb,
            None if ub_none else dub)


class _BoxQPFunction(torch.autograd.Function):
    """Canonical-layout ((B, n)) differentiable solve; returns x."""

    @staticmethod
    def forward(ctx, config, Q, p, A, b, lb, ub):
        # autograd runs this without recording a graph: the solve is a
        # plain forward, differentiated only through the implicit VJP.
        sol = solve_box_qp(Q, p, A, b, lb, ub, config)
        # The residual set: x, u, lams, nus, Q, A, lb, ub, rho.
        ctx.config = config
        ctx.none_bounds = (lb is None, ub is None)
        ctx.save_for_backward(sol.x, sol.u, sol.lams, sol.nus, Q, A, lb, ub,
                              sol.rho)
        return sol.x

    @staticmethod
    def backward(ctx, dl_dz):
        need = ctx.needs_input_grad          # (config, Q, p, A, b, lb, ub)
        res = (*ctx.saved_tensors, ctx.none_bounds)
        return (None, *_boxqp_bwd(ctx.config, res, dl_dz, want_dQ=need[1],
                                  want_dA=need[3]))


def boxqp(Q, p, A=None, b=None, lb=None, ub=None,
          config: BoxQPConfig = BoxQPConfig()):
    """Differentiable batched box-QP layer.

    Returns ``x`` in the caller's layout ((B, n, 1) in, (B, n, 1) out).
    Gradients flow to Q, p, A, b, lb and ub through the backward mode of
    ``config`` ('fixed_point', the default, or 'kkt'), or, with
    ``config.unroll``, through the unrolled iterations."""
    if config.unroll:
        return like_layout(solve_box_qp_unrolled(Q, p, A, b, lb, ub, config),
                           p)
    pv = as_vector(p, "p")
    bv = None if b is None else as_vector(b, "b")
    lbv = None if lb is None else as_vector(lb, "lb")
    ubv = None if ub is None else as_vector(ub, "ub")
    x = _BoxQPFunction.apply(config, Q, pv, A, bv, lbv, ubv)
    return like_layout(x, p)


class BoxQPLayer(nn.Module):
    """``nn.Module`` holding a config; ``forward`` is ``boxqp``."""

    def __init__(self, config: BoxQPConfig = BoxQPConfig()):
        super().__init__()
        self.config = config

    def forward(self, Q, p, A=None, b=None, lb=None, ub=None):
        return boxqp(Q, p, A, b, lb, ub, config=self.config)


class BoxQP(StatefulQP):
    """Stateful solve/update wrapper.

    With ``warm_start=True`` each ``solve()`` starts from the previous
    solution.  The scaling and KKT factorization are cached across solves
    and dropped only when an ``update()`` touches something other than
    ``p``."""

    _extra_fields = ("lb", "ub")

    def __init__(self, Q, p, A=None, b=None, lb=None, ub=None,
                 control: BoxQPConfig = BoxQPConfig(),
                 warm_start: bool = False):
        self._init(Q, p, A, b, lb, ub, control, warm_start)

    def _prepare(self):
        return prepare_box_qp(self.Q, self.A, self.b, self.lb, self.ub,
                              config=self.control)

    def _solve_prepared(self, prep, p, warm_start):
        return solve_box_qp_prepared(prep, p, config=self.control,
                                     warm_start=warm_start)

    def update(self, Q=None, p=None, A=None, b=None, lb=None, ub=None,
               control=None):
        self._update(Q, p, A, b, lb, ub, control)
