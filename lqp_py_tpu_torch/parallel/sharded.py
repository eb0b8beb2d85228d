"""Batch-sharded QP solving over a process mesh (counterpart of
``lqp_py_tpu.parallel.sharded``).

Each rank solves its shard of the batch (``mesh.shard_batch``).  Two
styles, as in the JAX package:

- ``solve_box_qp_sharded`` / ``boxqp_sharded``, and any solver called
  inside ``batch_sharded(mesh)``: every batch-wide reduction of the
  solver's host loop (the convergence and rho-update flags of a residual
  check, "any finite bound", the residual trace's maxima) is all-reduced
  over the mesh's ``dp`` group (``ops/collective.py``), one collective per
  check.  The ranks stay in lock step with the single-process solve of the
  whole batch: the same iteration count, the same per-element values.
  GSPMD inserts these collectives in the JAX package.  The backward of each
  element is local.
- ``solve_box_qp_shard_map``: each rank tests convergence on its own shard
  only and may stop at another iteration count; ``iterations`` is then a
  per-element tensor.

The functions take the whole batch on every rank and return the rank's
shard of the result.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models.box_qp import solve_box_qp
from lqp_py_tpu_torch.models.layers import boxqp
from lqp_py_tpu_torch.ops import collective
from lqp_py_tpu_torch.parallel.mesh import shard_batch


@contextlib.contextmanager
def batch_sharded(mesh: DeviceMesh, axis: str = "dp"):
    """Within the block, the solvers' batch-wide reductions are global over
    the mesh's ``axis`` group: call any solver (``solve_qp_gen``,
    ``solve_box_qp_ip``, ``solve_qp_optnet``, ...) on the rank's shard and
    it runs in lock step with the single-process solve."""
    with collective.batch_group(mesh.get_group(axis)):
        yield


def solve_box_qp_sharded(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None,
                         ub=None, config: BoxQPConfig = BoxQPConfig(),
                         axis: str = "dp"):
    """Batch-sharded forward solve in lock step with the whole batch.
    Returns the rank's shard of the ``BoxQPSolution``; ``iterations`` is
    the whole batch's."""
    args = shard_batch((Q, p, A, b, lb, ub), mesh, axis)
    with batch_sharded(mesh, axis):
        return solve_box_qp(*args, config=config)


def boxqp_sharded(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None, ub=None,
                  config: BoxQPConfig = BoxQPConfig(), axis: str = "dp"):
    """Batch-sharded differentiable layer call: the rank's rows of ``x``,
    with gradients flowing to the rank's rows of the inputs."""
    args = shard_batch((Q, p, A, b, lb, ub), mesh, axis)
    with batch_sharded(mesh, axis):
        return boxqp(*args, config=config)


def solve_box_qp_shard_map(mesh: DeviceMesh, Q, p, A=None, b=None,
                           lb=None, ub=None,
                           config: BoxQPConfig = BoxQPConfig(),
                           axis: str = "dp"):
    """Each rank solves its shard with a purely local convergence test, and
    may stop at another iteration count than its peers; per-element states
    are independent, so the solutions agree with the lock-step solve to
    the solver's tolerance.  ``iterations`` is broadcast to a per-element
    tensor, as the JAX function returns it."""
    sol = solve_box_qp(*shard_batch((Q, p, A, b, lb, ub), mesh, axis),
                       config=config)
    return dataclasses.replace(sol, iterations=torch.full(
        sol.converged.shape, sol.iterations, dtype=torch.int64,
        device=sol.converged.device))
