"""lqp_py_tpu_torch — the PyTorch / CUDA port of lqp_py_tpu.

A second package beside the JAX one, held against it by the parity tests
(tests/test_torch_*.py).  Ported so far: the box-QP ADMM solve, direct
(``solve_box_qp``) and prepared (``prepare_box_qp`` +
``solve_box_qp_prepared``), lock-step or with the per-element early-exit
step (``use_pallas_step=True``); the differentiable layer ``boxqp`` with
its fixed-point and KKT backward passes, ``BoxQPLayer`` and the stateful
``BoxQP``; the ``nn.Module``s of ``lqp_py_tpu_torch.nn`` and the
Experiment-2 trainer (``models/train.py``).  Its three kernels, the
128x128 SWEEP leaf of the SPD inverse, the early-exit GEMV and the
whole-matrix block-sweep inverse (``ops/kernels/block_inverse.py``, an
entry point of its own that no solver calls), are CUDA C++ for Hopper
(``csrc/``), built with nvcc on first use; on a CPU tensor their plain
PyTorch versions run instead.
"""

from lqp_py_tpu_torch.config import BoxQPConfig, box_qp_control
from lqp_py_tpu_torch.types import BoxQPSolution
from lqp_py_tpu_torch.models.box_qp import (
    BoxQPPrepared,
    prepare_box_qp,
    solve_box_qp,
    solve_box_qp_prepared,
)
from lqp_py_tpu_torch.models.layers import BoxQP, BoxQPLayer, boxqp

__all__ = [
    "BoxQPConfig", "box_qp_control", "BoxQPSolution", "BoxQPPrepared",
    "solve_box_qp", "prepare_box_qp", "solve_box_qp_prepared",
    "boxqp", "BoxQPLayer", "BoxQP",
]
