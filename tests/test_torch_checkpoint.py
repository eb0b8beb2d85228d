"""Checkpoint and resume of the port's Experiment-2 trainer
(``lqp_py_tpu_torch/utils/checkpoint.py``), the JAX package's
tests/test_checkpoint.py without its sharded case: training K epochs,
checkpointing, restoring into a fresh state and training the rest
reproduces the uninterrupted run's losses and parameters bitwise.  float64
on the CPU, the unrolled layer as in the JAX test."""

import numpy as np
import pytest
import torch

from lqp_py_tpu_torch import BoxQPConfig
from lqp_py_tpu_torch.models.train import init_params, make_train_scan
from lqp_py_tpu_torch.utils.checkpoint import (TrainState, checkpointed_run,
                                               init_train_state,
                                               latest_checkpoint,
                                               restore_train_state,
                                               save_train_state)
from lqp_py_tpu_torch.utils.generators import create_qp_data

N_X, N_FEAT, B, MB, EPOCHS = 8, 4, 16, 8, 6
F64 = torch.float64


@pytest.fixture(scope="module")
def workload():
    d = create_qp_data(N_X, B, seed=11, dtype=F64, device="cpu")
    rng = np.random.default_rng(5)
    features = torch.tensor(rng.normal(size=(B, N_FEAT)))
    sel = rng.integers(0, B, size=(EPOCHS, MB))
    run = make_train_scan(BoxQPConfig(eps_abs=1e-7, eps_rel=1e-7,
                                      unroll=True, unroll_iters=60))
    return run, sel, (features, *d)


def _params(seed=0):
    return init_params(N_FEAT, N_X, generator=torch.Generator().manual_seed(
        seed), dtype=F64, device="cpu")


def _state(seed=0):
    return init_train_state(_params(seed), EPOCHS, dtype=F64)


def _assert_same(a: TrainState, b: TrainState):
    assert a.epoch == b.epoch
    torch.testing.assert_close(a.losses, b.losses, rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(a.params.W, b.params.W)
    assert torch.equal(a.params.bias, b.params.bias)


def test_save_restore_roundtrip(tmp_path, workload):
    run, sel, data = workload
    state = checkpointed_run(run, _state(), sel, *data)
    assert state.epoch == EPOCHS and bool(torch.isfinite(state.losses).all())
    save_train_state(tmp_path / "ck", state)
    template = _state(seed=1)
    W0 = template.params.W.clone()
    restored = restore_train_state(tmp_path / "ck", template)
    _assert_same(restored, state)
    assert restored.losses.dtype == F64
    assert torch.equal(template.params.W, W0)    # the template is untouched


def test_resume_matches_uninterrupted(tmp_path, workload):
    run, sel, data = workload
    full = checkpointed_run(run, _state(), sel, *data)

    # Checkpoint every 2 epochs, stop after epoch 4, restore into a fresh
    # state (nothing carried in memory), finish with the full sel.
    root = tmp_path / "ckpts"
    checkpointed_run(run, _state(), sel[:4], *data, root=root, every=2)
    latest = latest_checkpoint(root)
    assert latest is not None and latest.name == "step_4"
    assert sorted(p.name for p in root.iterdir()) == ["step_2", "step_4"]
    resumed = restore_train_state(latest, _state(seed=1))
    assert resumed.epoch == 4 and bool(resumed.losses[4:].isnan().all())
    finished = checkpointed_run(run, resumed, sel, *data)
    _assert_same(finished, full)


@pytest.mark.parametrize("rows, epoch, match", [
    (slice(4, None), 4, "FULL run's sel"),
    (slice(None), 0, "only holds"),
], ids=["partial-sel-on-resume", "sel-longer-than-losses"])
def test_checkpointed_run_rejects_a_wrong_sel(workload, rows, epoch, match):
    """Epoch indices are global: a resumed state must be called with the
    full run's sel, and sel may not outrun the losses buffer."""
    run, sel, data = workload
    state = _state()._replace(epoch=epoch)
    if match == "only holds":
        sel = np.concatenate([sel, sel[:1]])
    with pytest.raises(ValueError, match=match):
        checkpointed_run(run, state, sel[rows], *data)


def test_rerun_over_existing_root_overwrites(tmp_path, workload):
    """A run retried from scratch with the same root replaces the stale
    step_* files; the writer itself refuses to replace one unless told
    to."""
    run, sel, data = workload
    root = tmp_path / "root"
    s1 = checkpointed_run(run, _state(), sel, *data, root=root, every=3)
    s2 = checkpointed_run(run, _state(), sel, *data, root=root, every=3)
    _assert_same(s1, s2)
    with pytest.raises(FileExistsError):
        save_train_state(root / f"step_{EPOCHS}", s2)
    save_train_state(root / f"step_{EPOCHS}", s2, overwrite=True)
    _assert_same(restore_train_state(root / f"step_{EPOCHS}", _state(2)), s2)
    assert latest_checkpoint(tmp_path / "absent") is None
