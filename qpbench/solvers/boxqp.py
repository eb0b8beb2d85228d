"""The box ADMM of lqp_py_tpu_torch: the layer ``boxqp`` (fixed-point
backward), the direct ``solve_box_qp`` and the prepared
``prepare_box_qp`` + ``solve_box_qp_prepared``."""

from __future__ import annotations

from lqp_py_tpu_torch import (BoxQPConfig, boxqp, prepare_box_qp,
                              solve_box_qp, solve_box_qp_prepared)
from lqp_py_tpu_torch.models import layers
from lqp_py_tpu_torch.ops.kernels import _build
from qpbench import watch


def load_kernels():
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    _build.load_library()


def config(options: dict) -> BoxQPConfig:
    return BoxQPConfig(**options)


def layer(d, cfg):
    """``(x, ok)``: the layer's output and, as a 0-d bool tensor on the
    device, whether its forward solve converged on every element (None if
    no solve was seen)."""
    with watch.Seen(layers, "solve_box_qp") as seen:
        x = boxqp(d.Q, d.p, d.A, d.b, d.lb, d.ub, config=cfg)
    return x, seen.ok


def solve(d, cfg):
    return solve_box_qp(d.Q, d.p, d.A, d.b, d.lb, d.ub, config=cfg)


def prepare(d, cfg):
    return prepare_box_qp(d.Q, d.A, d.b, d.lb, d.ub, config=cfg)


def solve_prepared(prep, p, cfg, warm=None):
    return solve_box_qp_prepared(prep, p, config=cfg, warm_start=warm)
