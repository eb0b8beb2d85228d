"""Process meshes and batch sharding over ``torch.distributed`` (counterpart
of ``lqp_py_tpu.parallel.mesh``).

The JAX package shards over a ``jax.sharding.Mesh`` of devices inside one
program, and GSPMD partitions every batched op.  Here each rank is a
process (launched torchrun-style, ``parallel/launch.py``) holding its own
shard, and a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks: a 1-D ``dp`` mesh by default, or ``(d, t)`` over
``("dp", "tp")``.  A sharded array is the rank's own slice, not a global
array.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: Every process group's timeout: a missing peer fails a collective after
#: this long instead of hanging the run.
DEFAULT_TIMEOUT_S = 300.0

#: The group of every rank of a mesh smaller than the world, by its ranks
#: (``make_mesh``; ``mesh_group``).
_WHOLE: dict = {}


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the world that the launcher's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` describe (``env://``).

    ``backend`` defaults to ``nccl`` where the rank has a CUDA device and
    ``gloo`` on the CPU; pass ``"gloo"`` to run several ranks on one card
    (NCCL refuses two ranks on one device).  No other backend is tried if
    the chosen one fails.  A rank with CUDA takes device ``LOCAL_RANK``
    modulo the device count.  A no-op when ``WORLD_SIZE`` is unset or at
    most 1: ``make_mesh`` then makes a world of this process alone."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or _default_backend(),
                            init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp",)) -> DeviceMesh:
    """A ``DeviceMesh`` over the first ``prod(shape)`` ranks of the world.

    Default: a 1-D ``dp`` mesh over every rank.  ``shape=(d, t)`` with
    ``axis_names=("dp", "tp")`` gives a 2-D one.  Raises when the shape
    needs more ranks than the world has.  Every rank of the world must call
    it (the mesh's process groups are made collectively); a rank outside a
    smaller mesh gets one whose ``get_coordinate()`` is None and takes no
    part in the mesh's solves.  Every group of the mesh gets the world's
    timeout, and so does the group of all its ranks (``mesh_group``).
    Without an initialized world, this process becomes a world of one rank
    on the default backend (``initialize_distributed``'s rule)."""
    if not dist.is_initialized():
        dist.init_process_group(
            _default_backend(), store=dist.HashStore(), rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the world "
                         f"has {world}")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = DeviceMesh(device_type, torch.arange(n).view(shape),
                      mesh_dim_names=tuple(axis_names))
    timeout = dist.group.WORLD._get_backend(
        torch.device(device_type)).options._timeout
    if len(shape) > 1 and n < world:
        _WHOLE[tuple(range(n))] = dist.new_group(list(range(n)),
                                                 timeout=timeout)
    if mesh.get_coordinate() is not None:
        # DeviceMesh gives new groups torch's default (30 min for gloo).
        for name in axis_names:
            dist.distributed_c10d._set_pg_timeout(timeout,
                                                  mesh.get_group(name))
    return mesh


def mesh_group(mesh: DeviceMesh):
    """The process group of every rank of ``mesh``, over all its axes: the
    world's when the mesh spans it, else the one ``make_mesh`` made."""
    if mesh.ndim == 1:
        return mesh.get_group()
    ranks = tuple(mesh.mesh.flatten().tolist())
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if ranks not in _WHOLE:
        raise ValueError(f"no process group of the mesh's ranks {ranks}: "
                         f"make the mesh with make_mesh")
    return _WHOLE[ranks]


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: str = "dp"):
    """The rank's shard of an ``ndim``-dimensional array whose leading axis
    is the batch, as a function ``x -> x[r·B/d : (r+1)·B/d]`` (r the rank's
    coordinate on ``axis``, d the axis' size; every other axis whole).  The
    counterpart of the JAX package's ``P(axis, None, ...)``; B must divide
    by d."""
    r = mesh.get_local_rank(axis)
    d = mesh.shape[mesh.mesh_dim_names.index(axis)]

    def take(x):
        if x.ndim != ndim:
            raise ValueError(f"batch_sharding for {ndim}-d arrays got "
                             f"shape {tuple(x.shape)}")
        B = x.shape[0]
        if B % d:
            raise ValueError(f"a batch of {B} does not split over {d} "
                             f"ranks of {axis!r}")
        k = B // d
        return x[r * k:(r + 1) * k]

    return take


def shard_batch(tree, mesh: DeviceMesh, axis: str = "dp"):
    """Every tensor of ``tree`` (a tensor, None, or a tuple, NamedTuple,
    list or dict of them) cut to the rank's shard of its batch axis
    (``batch_sharding``).  The results are the rank's shards, not global
    arrays; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return batch_sharding(mesh, tree.ndim, axis)(tree)
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batch(v, mesh, axis) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, mesh, axis) for v in tree)
    raise TypeError(f"shard_batch: unsupported leaf {type(tree).__name__}")
