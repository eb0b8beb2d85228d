"""The QP layers as ``torch.nn.Module``s (counterpart of ``lqp_py_tpu.nn``).

``BoxQPModule`` is the box-QP layer, ``OptNetModule`` the interior-point
layer, ``GenQPModule`` the general-inequality splitting layer;
``LinearBoxQP`` is the Experiment-2 architecture as one module.
"""

from __future__ import annotations

import torch
from torch import nn

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models.genqp import GenQPLayer
from lqp_py_tpu_torch.models.layers import BoxQPLayer, boxqp
from lqp_py_tpu_torch.models.optnet import OptNetLayer


#: The differentiable box-QP layer under the JAX package's name
#: (``lqp_py_tpu.nn.BoxQPModule``).
BoxQPModule = BoxQPLayer

#: The differentiable interior-point layer under the JAX package's name
#: (``lqp_py_tpu.nn.OptNetModule``).
OptNetModule = OptNetLayer

#: The differentiable general-inequality layer under the JAX package's name
#: (``lqp_py_tpu.nn.GenQPModule``).
GenQPModule = GenQPLayer


class LinearBoxQP(nn.Module):
    """A linear ``cost_head`` predicts the QP cost vector p from features,
    the box-QP layer solves the QP (experiments/experiment_2.py).

    The parameters are made on ``device`` (the card unless the caller asks
    for another).  ``cost_head.weight`` is (n_x, n_features): the transpose
    of the flax Dense kernel (``utils.convert.linear_box_qp_from_flax``)."""

    def __init__(self, n_features: int, n_x: int,
                 config: BoxQPConfig = BoxQPConfig(),
                 device=torch.device("cuda"), dtype=torch.float32):
        super().__init__()
        self.config = config
        self.cost_head = nn.Linear(n_features, n_x, device=device,
                                   dtype=dtype)

    def forward(self, features, Q, A=None, b=None, lb=None, ub=None):
        return boxqp(Q, self.cost_head(features), A, b, lb, ub,
                     config=self.config)
