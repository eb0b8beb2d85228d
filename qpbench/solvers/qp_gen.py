"""The general-inequality splitting solver of lqp_py_tpu_torch, with the
box given as G = [-I; I], h = [-lb; ub] (Experiment 1's OptNet/SCS
columns): the layer ``qp_gen`` (KKT backward).  G is a batch-expanded
view of one (2n, n) matrix."""

from __future__ import annotations

import torch

from lqp_py_tpu_torch import GenQPConfig, qp_gen
from lqp_py_tpu_torch.models import genqp
from lqp_py_tpu_torch.ops.kernels import _build
from qpbench import watch


def load_kernels():
    _build.load_library()


def config(options: dict) -> GenQPConfig:
    return GenQPConfig(**options)


def _G_h(d):
    B, n = d.p.shape
    eye = torch.eye(n, dtype=d.Q.dtype, device=d.Q.device)
    G = torch.cat([-eye, eye], dim=0).expand(B, 2 * n, n)
    return G, torch.cat([-d.lb, d.ub], dim=-1)


def layer(d, cfg):
    """``(x, ok)``, as ``boxqp.layer``."""
    with watch.Seen(genqp, "solve_qp_gen") as seen:
        x = qp_gen(d.Q, d.p, d.A, d.b, *_G_h(d), config=cfg)
    return x, seen.ok
