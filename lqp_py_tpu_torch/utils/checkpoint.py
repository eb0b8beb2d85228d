"""Checkpoint and resume of the Experiment-2 trainer (counterpart of
``lqp_py_tpu.utils.checkpoint``, on ``torch.save``/``torch.load`` in place
of orbax).

A ``TrainState`` is the model's parameters (``models/train.LinearQP``), the
number of epochs done and the loss trajectory so far.  ``checkpointed_run``
drives a ``make_train_scan`` run in chunks and writes ``root/step_<epoch>``
after each; resuming from the latest one with the full run's index matrix
reproduces the uninterrupted run (tests/test_torch_checkpoint.py).
"""

from __future__ import annotations

import copy
import os
import pathlib
from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from lqp_py_tpu_torch.models.train import LinearQP


class TrainState(NamedTuple):
    """Resumable state of the Experiment-2 workload."""

    params: LinearQP
    epoch: int              # epochs completed
    losses: torch.Tensor    # (n_epochs,); entries past ``epoch`` are nan


def init_train_state(params: LinearQP, n_epochs: int,
                     dtype=torch.float32) -> TrainState:
    """A fresh state; the losses live on the parameters' device."""
    return TrainState(params=params, epoch=0,
                      losses=torch.full((n_epochs,), torch.nan, dtype=dtype,
                                        device=params.W.device))


def save_train_state(path, state: TrainState, *, overwrite: bool = False
                     ) -> None:
    """Write ``state`` to the file ``path``.  ``overwrite=False`` raises if
    ``path`` exists; the file is written beside it and renamed into place,
    so a reader never sees a partial checkpoint."""
    path = pathlib.Path(path).absolute()
    if path.exists() and not overwrite:
        raise FileExistsError(f"checkpoint {path} already exists; pass "
                              f"overwrite=True to replace it")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    torch.save({"params": state.params.state_dict(),
                "epoch": int(state.epoch), "losses": state.losses}, tmp)
    os.replace(tmp, path)


def restore_train_state(path, template: TrainState) -> TrainState:
    """Restore a state saved by :func:`save_train_state`.

    ``template`` gives the structure, dtypes and devices: pass a freshly
    initialized state, e.g. ``init_train_state(init_params(...),
    n_epochs)``.  A parameter of the template that is a ``DTensor`` (say
    ``W`` sharded over a mesh's 'tp' axis) comes back with the template's
    mesh and placements, each rank keeping its own shard of the saved
    (unsharded) value.  The stored values go into a copy of the template's
    parameters; the template is left as it was."""
    saved = torch.load(pathlib.Path(path), map_location="cpu",
                       weights_only=True)
    params = copy.deepcopy(template.params)
    like = params.state_dict()
    params.load_state_dict(
        {k: _placed_like(v, like[k]) for k, v in saved["params"].items()},
        assign=True)
    losses = saved["losses"].to(dtype=template.losses.dtype,
                                device=template.losses.device)
    return TrainState(params=params, epoch=int(saved["epoch"]),
                      losses=losses)


def _placed_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``value`` in ``like``'s dtype and device, and for a ``DTensor`` its
    mesh and placements (every rank holds the whole saved value, so each
    takes its shard without communication)."""
    if isinstance(like, DTensor):
        return distribute_tensor(
            value.to(dtype=like.dtype, device=like.device_mesh.device_type),
            like.device_mesh, like.placements, src_data_rank=None)
    return value.to(dtype=like.dtype, device=like.device)


def latest_checkpoint(root) -> Optional[pathlib.Path]:
    """The highest-numbered ``step_*`` checkpoint under ``root`` (the
    layout :func:`checkpointed_run` writes), or None."""
    root = pathlib.Path(root)
    if not root.is_dir():
        return None
    steps = sorted(root.glob("step_*"),
                   key=lambda p: int(p.name.split("_")[1]))
    return steps[-1] if steps else None


def checkpointed_run(run, state: TrainState, sel, *data, root=None,
                     every: int = 0) -> TrainState:
    """Drive a ``make_train_scan`` ``run`` in checkpointed chunks.

    Splits the epoch index matrix ``sel`` into chunks of ``every`` epochs
    (``every=0``: one chunk) and, where ``root`` is given, writes
    ``root/step_<epoch>`` after each, replacing what an earlier attempt
    left there.  ``run`` updates ``state.params`` in place, as
    ``make_train_scan``'s SGD steps do.  To resume, restore the latest
    checkpoint and call again with the SAME full-run ``sel``:
    ``state.epoch`` says how many rows are done.
    """
    n_epochs = sel.shape[0]
    if n_epochs > state.losses.shape[0]:
        raise ValueError(
            f"sel has {n_epochs} epochs but state.losses only holds "
            f"{state.losses.shape[0]}.")
    done = int(state.epoch)
    if done > 0 and n_epochs != state.losses.shape[0]:
        # Epoch indices are global: rows already done are skipped by
        # state.epoch, so the remaining rows alone would train the wrong
        # epochs and write their losses into the wrong slots.
        raise ValueError(
            f"resuming at epoch {done} with a {n_epochs}-row "
            f"sel, but state.losses was sized for "
            f"{state.losses.shape[0]} epochs: pass the FULL run's sel, "
            f"not the remaining rows.")
    chunk = every if every > 0 else n_epochs
    for start in range(done, n_epochs, chunk):
        stop = min(start + chunk, n_epochs)
        params, losses = run(state.params, sel[start:stop], *data)
        new_losses = state.losses.clone()
        new_losses[start:stop] = losses.to(new_losses.dtype)
        state = TrainState(params=params, epoch=stop, losses=new_losses)
        if root is not None:
            save_train_state(pathlib.Path(root) / f"step_{stop}", state,
                             overwrite=True)
    return state
