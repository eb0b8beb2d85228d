"""lqp_py_tpu_torch — the PyTorch / CUDA port of lqp_py_tpu.

A second package beside the JAX one, held against it by the parity tests
(tests/test_torch_*.py).  Ported so far: the box-QP ADMM solve, direct
(``solve_box_qp``) and prepared (``prepare_box_qp`` +
``solve_box_qp_prepared``), lock-step or with the per-element early-exit
step (``use_pallas_step=True``), with polish, Anderson acceleration and the
Cholesky KKT mode; the unrolled solve (``solve_box_qp_unrolled``); the
differentiable layer ``boxqp`` with its fixed-point, KKT and unrolled
backward passes, ``BoxQPLayer`` and the stateful ``BoxQP``; the
equality-constrained and unconstrained solvers (``qp_eqcon``,
``qp_uncon``); the interior-point solvers, box-structured
(``solve_box_qp_ip``, ``boxqp_ip``) and general (``solve_qp_optnet``,
``qp_optnet``, ``OptNetLayer``; Schur and condensed factorizations, polish
and the KKT implicit backward); the general-inequality splitting solver
(``solve_qp_gen``, ``prepare_qp_gen`` + ``solve_qp_gen_prepared``,
``qp_gen``, ``GenQPLayer``, the stateful ``GenQP``; KKT and conic
backward passes; ``scs_control``); the ``nn.Module``s of
``lqp_py_tpu_torch.nn``, the Experiment-2 trainer (``models/train.py``),
its checkpoints (``utils/checkpoint.py``, restored onto a template
sharded over a mesh too) and the timing helpers of ``utils/profiling.py``;
and the distribution layer ``lqp_py_tpu_torch.parallel`` over
``torch.distributed``: batch-sharded lock-step solves for every solver
family ('dp'), the column-sharded solves of every solver family ('tp'; the
box ADMM in both KKT modes, with polish, Anderson and the early-exit
step), the dp x tp Experiment-2 trainer and its dry run.  Its
three kernels, the 128x128 SWEEP leaf of the
SPD inverse, the early-exit GEMV and the whole-matrix block-sweep inverse
(``ops/kernels/block_inverse.py``, an entry point of its own that no
solver calls), are CUDA C++ for Hopper (``csrc/``), built with nvcc on
first use; on a CPU tensor their plain PyTorch versions run instead.
"""

from lqp_py_tpu_torch.config import (BoxQPConfig, GenQPConfig, OptNetConfig,
                                     box_qp_control, genqp_control,
                                     optnet_control, scs_control)
from lqp_py_tpu_torch.types import BoxQPSolution, EqQPSolution, QPSolution
from lqp_py_tpu_torch.models.box_qp import (
    BoxQPPrepared,
    prepare_box_qp,
    solve_box_qp,
    solve_box_qp_prepared,
    solve_box_qp_unrolled,
)
from lqp_py_tpu_torch.models.layers import BoxQP, BoxQPLayer, boxqp
from lqp_py_tpu_torch.models.eqcon import qp_eqcon, solve_qp_eqcon
from lqp_py_tpu_torch.models.uncon import qp_uncon, solve_qp_uncon
from lqp_py_tpu_torch.models.box_ip import boxqp_ip, solve_box_qp_ip
from lqp_py_tpu_torch.models.optnet import (OptNetLayer, qp_optnet,
                                            solve_qp_optnet)
from lqp_py_tpu_torch.models.genqp import (GenQP, GenQPLayer, prepare_qp_gen,
                                           qp_gen, solve_qp_gen,
                                           solve_qp_gen_prepared)

__all__ = [
    "BoxQPConfig", "box_qp_control", "BoxQPSolution", "EqQPSolution",
    "BoxQPPrepared", "solve_box_qp", "solve_box_qp_unrolled",
    "prepare_box_qp", "solve_box_qp_prepared",
    "boxqp", "BoxQPLayer", "BoxQP",
    "qp_eqcon", "solve_qp_eqcon", "qp_uncon", "solve_qp_uncon",
    "OptNetConfig", "optnet_control", "QPSolution", "solve_box_qp_ip",
    "boxqp_ip", "solve_qp_optnet", "qp_optnet", "OptNetLayer",
    "GenQPConfig", "genqp_control", "scs_control", "prepare_qp_gen",
    "solve_qp_gen_prepared", "GenQP", "GenQPLayer", "qp_gen", "solve_qp_gen",
]
