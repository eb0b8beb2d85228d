"""End-to-end learning through the QP layer, the Experiment-2 workload
(counterpart of ``lqp_py_tpu.models.train``).

A linear model predicts the QP cost vector ``p_hat = features W + bias``,
the box-QP layer solves the QP, and the loss is the true QP objective
``0.5 z'Qz + p'z`` at the layer's output.  Training is plain SGD
(``w -= lr * grad``, no momentum), one step per minibatch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models.layers import boxqp


class LinearQP(nn.Module):
    """Parameters of the linear cost model in the JAX package's layout:
    ``W`` (n_features, n_x) and ``bias`` (n_x,), so that weights carry
    across unchanged (``utils.convert.linear_qp_from_numpy``)."""

    def __init__(self, W: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.W = nn.Parameter(W)
        self.bias = nn.Parameter(bias)


def init_params(n_features: int, n_x: int,
                generator: torch.Generator = None, dtype=torch.float32,
                device=torch.device("cuda")) -> LinearQP:
    """W ~ N(0, 1/n_features), bias 0, as the JAX package draws them (from
    another stream: a ``torch.Generator`` on ``device``)."""
    W = torch.randn((n_features, n_x), generator=generator, dtype=dtype,
                    device=device) / math.sqrt(n_features)
    return LinearQP(W, torch.zeros((n_x,), dtype=dtype, device=device))


def predict_p(params: LinearQP, features):
    """features (B, n_features) -> p_hat (B, n_x)."""
    return features @ params.W + params.bias


def qp_objective(Q, p, z):
    """True QP objective 0.5 z'Qz + p'z, averaged over the batch."""
    Qz = (Q @ z[..., None])[..., 0]
    return torch.mean(0.5 * torch.sum(z * Qz, dim=-1)
                      + torch.sum(p * z, dim=-1))


def make_train_step(config: BoxQPConfig, lr: float = 5e-4):
    """Returns ``step(params, features, Q, p_true, A, b, lb, ub) ->
    (params, loss)``: one SGD step on ``params`` (in place), and the loss
    before it."""

    def step(params: LinearQP, features, Q, p_true, A, b, lb, ub):
        z = boxqp(Q, predict_p(params, features), A, b, lb, ub,
                  config=config)
        loss = qp_objective(Q, p_true, z)
        gW, gb = torch.autograd.grad(loss, (params.W, params.bias))
        with torch.no_grad():
            params.W -= lr * gW
            params.bias -= lr * gb
        return params, loss.detach()

    return step


def make_train_scan(config: BoxQPConfig, lr: float = 5e-4):
    """Whole-run training over an ``(epochs, mini_batch)`` index matrix:
    returns ``run(params, sel, features, Q, p_true, A, b, lb, ub) ->
    (params, losses)``, one SGD step per row of ``sel`` on the gathered
    minibatch, and the per-step losses as a tensor."""
    step = make_train_step(config, lr=lr)

    def run(params, sel, features, Q, p_true, A, b, lb, ub):
        data = (features, Q, p_true, A, b, lb, ub)
        losses = []
        for idx in sel:
            mb = [None if v is None else v[idx] for v in data]
            params, loss = step(params, *mb)
            losses.append(loss)
        return params, torch.stack(losses)

    return run
