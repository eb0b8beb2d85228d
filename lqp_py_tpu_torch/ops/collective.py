"""Batch-wide reductions of the solvers' host loops, made global over a
data-parallel process group.

Under the JAX package's GSPMD a batch-sharded solve stays in lock step with
the single-device one: every batch-wide reduction (``jnp.all(is_optimal)``
in a while condition, ``jnp.max(lb)``) is partitioned into a collective by
the compiler.  The port's solvers make those reductions on the tensors
they hold, which under ``torch.distributed`` is one rank's shard of the
batch.  Each such reduction goes through this module instead: inside
``batch_group(group)`` it is all-reduced over ``group``, outside it (or
with a group of one rank) it is returned as it is.  A caller stacks every
flag of one residual check into one tensor, so that a check costs one
collective and one device-to-host read.

``parallel/sharded.py`` and ``parallel/tp.py`` set the group; nothing else
does.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

#: All-reduces made by this module in this process (local reductions with
#: no group set do not count).
COLLECTIVES = 0

_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group",
                                                       default=None)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@contextlib.contextmanager
def batch_group(group):
    """Make the solvers' batch-wide reductions global over ``group`` (a
    ``torch.distributed`` process group holding the batch's shards) for the
    duration of the block."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def _reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    global COLLECTIVES
    group = _GROUP.get()
    if group is None or dist.get_world_size(group) == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    COLLECTIVES += 1
    return out


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of ``t`` over the batch group's ranks."""
    return _reduce(t, "sum")


def batch_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the batch group's ranks."""
    return _reduce(t, "max")


def batch_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean of the 1-D per-element tensor ``v`` over the whole batch
    (``v.mean()`` itself with no group set)."""
    if _GROUP.get() is None:
        return v.mean()
    tot = batch_sum(torch.stack([v.sum(), v.new_tensor(float(v.numel()))]))
    return tot[0] / tot[1]


def batch_any(flags: torch.Tensor) -> torch.Tensor:
    """Elementwise "any rank's flag is set" of a bool tensor of per-rank
    flags (carried as int32: not every backend reduces bool)."""
    return _reduce(flags.to(torch.int32), "max") > 0
