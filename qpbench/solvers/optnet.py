"""The interior point of lqp_py_tpu_torch (OptNet), with the box given as
G = [-I; I], h = [-lb; ub] (Experiment 1's OptNet column): the layer
``qp_optnet`` (KKT backward).  G is a batch-expanded view of one (2n, n)
matrix.

The layer's forward returns x alone, so the adapter watches the solve it
calls for the forward's ``converged``: ``_solve_ip`` (solution, factors and
the backward's multipliers), or ``_solve_qp_optnet_full`` (solution and
factors) in a port that has no ``_solve_ip``."""

from __future__ import annotations

import torch

from lqp_py_tpu_torch import OptNetConfig, qp_optnet
from lqp_py_tpu_torch.models import optnet
from lqp_py_tpu_torch.ops.kernels import _build


def load_kernels():
    _build.load_library()


def config(options: dict) -> OptNetConfig:
    return OptNetConfig(**options)


def _G_h(d):
    B, n = d.p.shape
    eye = torch.eye(n, dtype=d.Q.dtype, device=d.Q.device)
    G = torch.cat([-eye, eye], dim=0).expand(B, 2 * n, n)
    return G, torch.cat([-d.lb, d.ub], dim=-1)


def layer(d, cfg):
    """``(x, ok)``, as ``boxqp.layer``: ``ok`` is the forward solve's
    ``converged.all()`` as a 0-d bool tensor on the device, read without a
    host sync (None if no solve was seen)."""
    name = solve_name()
    real = getattr(optnet, name)
    seen = []

    def watched(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0].converged.all())
        return out

    setattr(optnet, name, watched)
    try:
        x = qp_optnet(d.Q, d.p, d.A, d.b, *_G_h(d), config=cfg)
    finally:
        setattr(optnet, name, real)
    return x, seen[-1] if seen else None


def solve_name() -> str:
    """The module-level solve that the layer's forward calls."""
    return ("_solve_ip" if hasattr(optnet, "_solve_ip")
            else "_solve_qp_optnet_full")
