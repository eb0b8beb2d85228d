"""Matmul-precision scoping for solver entry points.

TF32 keeps about three decimal digits, and the solver targets 1e-5 KKT
residuals.  Every solver entry point runs with float32 matmuls at full
precision (the counterpart of ``jax.default_matmul_precision("highest")``
in lqp_py_tpu/ops/precision.py), and puts the caller's settings back on
exit.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def highest_matmul_precision():
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    fp32_prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(fp32_prec)
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def solver_precision(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with highest_matmul_precision():
            return fn(*args, **kwargs)
    return wrapped
