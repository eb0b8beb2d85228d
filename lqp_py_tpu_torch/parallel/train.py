"""The Experiment-2 trainer over a ('dp', 'tp') mesh: the counterpart of the
SGD step that ``__graft_entry__.dryrun_multichip`` jits under GSPMD, with
the linear model's ``W`` (n_features, n_x) and ``bias`` column-sharded over
'tp' and the minibatch sharded over 'dp'.

One step on a rank:

- ``features @ W_loc + bias_loc`` on its columns (``tp_columns``), and
  ``p_hat`` gathered over 'tp' (an all-reduce of a zero-filled buffer,
  ``_TP.gather``), bitwise the same on every tp rank;
- the solve and its backward through ``boxqp`` inside
  ``batch_sharded(mesh, 'dp')``, in lock step with the one-process solve
  of the whole minibatch; the tp ranks of one dp shard solve the same
  shard and agree bitwise;
- ``dL/dp_hat`` of the shard's summed objective, the rank's columns of it
  taken into ``dW_loc = features^T g[:, cols]`` and ``dbias_loc``, and one
  all-reduce over 'dp' of both with the summed objective and the shard's
  size, after which each is divided by the whole minibatch's size: the
  loss is the mean over the whole minibatch (``models/train.qp_objective``),
  whatever the shards' sizes.

The parameters are the rank's own block (``shard_linear_qp``), a
``LinearQP`` of its columns, updated in place.  To checkpoint the sharded
trainer, each rank drives ``utils/checkpoint.checkpointed_run`` with a
root of its own and restores onto a template of its own block.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models.layers import boxqp
from lqp_py_tpu_torch.models.train import LinearQP
from lqp_py_tpu_torch.parallel.mesh import shard_batch
from lqp_py_tpu_torch.parallel.sharded import batch_sharded
from lqp_py_tpu_torch.parallel.tp import tp_columns
from lqp_py_tpu_torch.parallel.tp_ops import _TP
from lqp_py_tpu_torch.utils.convert import CUDA, linear_qp_from_numpy


def shard_linear_qp(params, mesh: DeviceMesh, model_axis: str = "tp",
                    device=CUDA) -> LinearQP:
    """The rank's column block of ``params``: a ``LinearQP`` of ``W[:,
    cols]`` and ``bias[cols]`` for the rank's ``tp_columns`` (the columns
    of the tp solves, L per rank rounded up to the pivot width, not n/t).
    ``params`` is a ``LinearQP`` or the JAX package's ``LinearQPParams`` as
    numpy arrays (``utils/convert.linear_qp_from_numpy``); the block goes
    to ``device``."""
    if not isinstance(params, LinearQP):
        params = linear_qp_from_numpy(params, device=device)
    cols = tp_columns(mesh, params.W.shape[-1], model_axis)
    return LinearQP(params.W.detach()[:, cols].to(device).clone(),
                    params.bias.detach()[cols].to(device).clone())


def make_train_step_sharded(mesh: DeviceMesh, config: BoxQPConfig,
                            lr: float = 5e-4, batch_axis: str = "dp",
                            model_axis: str = "tp"):
    """``models/train.make_train_step`` over ``mesh``: returns
    ``step(params_local, features, Q, p_true, A, b, lb, ub) ->
    (params_local, loss)`` taking the rank's block of the parameters
    (``shard_linear_qp``) and its ``batch_axis`` shard of the minibatch,
    updating the block in place and returning the whole minibatch's loss
    (the same on every rank)."""
    dp_group = mesh.get_group(batch_axis)

    def step(params: LinearQP, features, Q, p_true, A, b, lb, ub):
        tp = _TP(mesh, model_axis, Q.shape[-1])
        cols = tp.cols(tp.c)
        with torch.no_grad():
            part = features @ params.W + params.bias
        p_hat = tp.gather(part, padded=False).requires_grad_()
        with batch_sharded(mesh, batch_axis):
            z = boxqp(Q, p_hat, A, b, lb, ub, config=config)
        Qz = (Q @ z[..., None])[..., 0]
        total = torch.sum(0.5 * torch.sum(z * Qz, dim=-1)
                          + torch.sum(p_true * z, dim=-1))
        g = torch.autograd.grad(total, p_hat)[0][:, cols]
        with torch.no_grad():
            sums = torch.cat([(features.mT @ g).flatten(), g.sum(dim=0),
                              total[None], total.new_tensor([Q.shape[0]])])
            if dist.get_world_size(dp_group) > 1:
                dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=dp_group)
            k = params.bias.shape[0]
            sums = sums / sums[-1]
            params.W -= lr * sums[:-k - 2].view_as(params.W)
            params.bias -= lr * sums[-k - 2:-2]
        return params, sums[-2]

    return step


def make_train_scan_sharded(mesh: DeviceMesh, config: BoxQPConfig,
                            lr: float = 5e-4, batch_axis: str = "dp",
                            model_axis: str = "tp"):
    """``models/train.make_train_scan`` over ``mesh``: returns ``run(
    params_local, sel, features, Q, p_true, A, b, lb, ub) -> (params_local,
    losses)``, one ``make_train_step_sharded`` step per row of the
    ``(epochs, mini_batch)`` index matrix ``sel``.  The data are the whole
    training set on every rank; each rank gathers its ``batch_axis`` shard
    of each minibatch (``mesh.shard_batch`` of the row's indices)."""
    step = make_train_step_sharded(mesh, config, lr, batch_axis, model_axis)

    def run(params, sel, features, Q, p_true, A, b, lb, ub):
        data = (features, Q, p_true, A, b, lb, ub)
        losses = []
        for idx in torch.as_tensor(sel):
            idx = shard_batch(idx.to(Q.device), mesh, batch_axis)
            params, loss = step(params, *(None if v is None else v[idx]
                                          for v in data))
            losses.append(loss)
        return params, torch.stack(losses)

    return run
