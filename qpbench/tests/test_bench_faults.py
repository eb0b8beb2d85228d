"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the port (the solve that produces every answer,
or the backward that produces every gradient) and the rest of the run is
the harness's own, at a tiny size on the CPU: half of the batch left
unsolved, one answer altered where it is produced, a solve that stops
before it converges, for warm serving a request answered with the previous
answer, and for training one element's gradient altered.  A sound run at
the same size comes out correct."""

import dataclasses

import pytest
import torch

from lqp_py_tpu_torch.models import box_qp, box_qp_grad, genqp, layers
from qpbench.tests import _tiny

CELLS = ["exp1-fwdbwd", "genqp-fwdbwd", "exp1-serve-warm", "exp1-serve-cold"]


def _half(sol, warm):
    x = sol.x.clone()
    x[x.shape[0] // 2:] = 0.0
    return {"x": x}


def _altered(sol, warm):
    x = sol.x.clone()
    x[-1, 3] += 0.05
    return {"x": x}


def _stale(sol, warm):
    return {"x": sol.x if warm is None else warm.x.clone()}


def _unconverged(sol, warm):
    """Stopped early: the answer as it stands, one element not converged."""
    ok = sol.converged.clone()
    ok[-1] = False
    return {"converged": ok}


FAULTS = {"half_batch": _half, "altered_answer": _altered,
          "stale_answer": _stale, "unconverged": _unconverged}


def _plant(monkeypatch, fault):
    for mod, name, warm_at in ((box_qp, "_solve_scaled", 11),
                               (genqp, "_solve_gen_scaled", 4)):
        real = getattr(mod, name)

        def broken(*args, _real=real, _at=warm_at, **kw):
            sol = _real(*args, **kw)
            warm = args[_at] if len(args) > _at else kw.get("warm_start")
            return dataclasses.replace(sol, **fault(sol, warm))
        monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _tiny.run(name)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer",
                                   "unconverged"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    _plant(monkeypatch, FAULTS[fault])
    r = _tiny.run(name)
    assert not r["correct"], r["checks"]


def test_stale_warm_answer_is_not_correct(monkeypatch):
    _plant(monkeypatch, _stale)
    r = _tiny.run("exp1-serve-warm")
    assert not r["correct"], r["checks"]


def _one_gradient_altered(grads):
    """Every gradient right but one element's dp (and so its dQ)."""
    dQ, dp, *rest = grads
    dp = dp.clone()
    dp[-1] *= 1.5
    dQ = dQ.clone()
    dQ[-1] *= 1.5
    return (dQ, dp, *rest)


@pytest.mark.parametrize("name", ["exp1-fwdbwd", "genqp-fwdbwd"])
def test_one_wrong_gradient_is_not_correct(monkeypatch, name):
    """One element of the batch: under a tenth, so the 90th percentile
    passes it and the largest has to catch it."""
    if name == "exp1-fwdbwd":
        real = box_qp_grad.box_qp_grad_fixed_point
        monkeypatch.setattr(
            box_qp_grad, "box_qp_grad_fixed_point",
            lambda *a, **k: _one_gradient_altered(real(*a, **k)))
    else:
        real = genqp._genqp_grads
        monkeypatch.setattr(
            genqp, "_genqp_grads",
            lambda *a, **k: _one_gradient_altered(real(*a, **k)))
    cell = _tiny.cell(name)
    cell.traffic["batch"] = 24
    from qpbench.run import run_cell
    torch.set_num_threads(2)
    r = run_cell(cell, _tiny.SEED, 0.3, False, torch.device("cpu"))
    assert not r["correct"], r["checks"]
    assert r["checks"]["dp_err_p90"]["value"] <= \
        r["checks"]["dp_err_p90"]["limit"], r["checks"]


def test_layer_watch_restores_the_solve():
    real = layers.solve_box_qp
    r = _tiny.run("exp1-fwdbwd")
    assert layers.solve_box_qp is real
    assert r["failed"] == 0 and r["checks"]["failed"]["value"] == 0
