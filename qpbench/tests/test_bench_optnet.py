"""The ``optnet-fwdbwd`` cell at a tiny size on the CPU: the adapter's
``(x, ok)``, a sound run correct with and without the trace (the judge's
numbers finite), ``ip_factors.train`` against the solves' own iteration
counts, faults planted in the solve and in the backward caught, and the
cell in the training metrics' lists."""

import dataclasses
import math

import pytest
import torch

from lqp_py_tpu_torch.models import optnet
from qpbench import data, harness, trace
from qpbench import run as R
from qpbench.tests import _tiny

NAME = "optnet-fwdbwd"


def test_adapter_gives_x_and_the_forward_convergence():
    cell = _tiny.cell(NAME)
    d = data.make(cell.config["problem"], _tiny.BATCH,
                  data.generator(_tiny.SEED, "cpu"), "cpu")
    assert cell.solver.solve_name() == "_solve_ip"
    real = optnet._solve_ip
    x, ok = cell.solver.layer(d, cell.solver.config(cell.config["options"]))
    assert optnet._solve_ip is real
    assert x.shape == (_tiny.BATCH, _tiny.N_X)
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)


@pytest.fixture
def iterations(monkeypatch):
    """The interior point's iteration count of every forward solve."""
    seen = []
    real = optnet._solve_ip

    def counted(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0].iterations)
        return out
    monkeypatch.setattr(optnet, "_solve_ip", counted)
    return seen


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    r = _tiny.run(NAME, trace=traced)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    for name, check in r["checks"].items():
        assert math.isfinite(check["value"]), name
    if not traced:
        assert set(r["metrics"]) == {"setup_s", "step_ms"}


def test_ip_factors_reads_the_iterations(iterations):
    """The traced window of the tiny cell: one ``lqp.factorize`` span in
    the loop per iteration of each traced step's forward.  A CPU trace has
    no device activity, so one stands in for the card's kernels (the span
    readers read nothing from a trace without device work)."""
    torch.set_num_threads(2)
    cell = _tiny.cell(NAME)
    cpu = torch.device("cpu")
    work = cell.kind.setup(cell, _tiny.SEED, cpu)
    work.warmup()
    run = R.Run(cell)
    units = int(cell.traffic["trace_units"])
    R.traced(work, cpu, units, run)
    reader = harness.load_module("metrics", "ip_factors.train")
    assert reader.read(run) is None
    lo, hi = run.trace.window
    run.trace.device.append(trace.Activity("kernel", lo, hi - lo))
    traced = iterations[-units:]
    assert min(traced) >= 1
    assert reader.read(run) == pytest.approx(sum(traced) / units)


def _planted(monkeypatch, change):
    real = optnet._solve_ip

    def broken(*args, **kw):
        sol, *rest = real(*args, **kw)
        return (change(sol), *rest)
    monkeypatch.setattr(optnet, "_solve_ip", broken)


def _unconverged(sol):
    ok = sol.converged.clone()
    ok[-1] = False
    return dataclasses.replace(sol, converged=ok)


def _altered(sol):
    x = sol.x.clone()
    x[-1, 3] += 0.05
    return dataclasses.replace(sol, x=x)


@pytest.mark.parametrize("change", [_unconverged, _altered])
def test_fault_in_the_solve_is_not_correct(monkeypatch, change):
    _planted(monkeypatch, change)
    r = _tiny.run(NAME)
    assert not r["correct"], r["checks"]


def _zero(g):
    """A backward that leaves the gradient as it was: zeros."""
    return torch.zeros_like(g)


def _nan(g):
    return torch.full_like(g, math.nan)


def _half(g):
    """Gradients for the first half of the batch alone."""
    g = g.clone()
    g[g.shape[0] // 2:] = 0.0
    return g


def _one(g):
    """Every gradient right but one element's, 1.5 times too large."""
    g = g.clone()
    g[-1] *= 1.5
    return g


@pytest.mark.parametrize("change", [_zero, _nan, _half, _one])
def test_fault_in_the_backward_is_not_correct(monkeypatch, change):
    """dp and dQ altered where the layer's backward makes them; the
    forward, and so x, as it was.  One element of 24 is under a tenth, so
    the 90th percentiles pass it and the largest have to catch it."""
    real = optnet.optnet_grads

    def broken(*args, **kw):
        dQ, dp, *rest = real(*args, **kw)
        return (change(dQ), change(dp), *rest)
    monkeypatch.setattr(optnet, "optnet_grads", broken)
    cell = _tiny.cell(NAME)
    cell.traffic["batch"] = 24
    torch.set_num_threads(2)
    r = R.run_cell(cell, _tiny.SEED, 0.3, False, torch.device("cpu"))
    assert not r["correct"], r["checks"]
    assert r["checks"]["x_err"]["value"] <= r["checks"]["x_err"]["limit"]
    if change is _one:
        assert (r["checks"]["dp_err_p90"]["value"]
                <= r["checks"]["dp_err_p90"]["limit"]), r["checks"]


def test_cell_is_in_the_training_metrics():
    cell = harness.Cell(NAME)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "step_ms"}
    assert {m["name"] for m in cell.per_layer} == {
        "fwd_ms.train", "bwd_ms.train", "leaf_roofline_pct.train",
        "device_idle_pct.train", "loop_idle_ms.train",
        "check_idle_ms.train", "ip_factors.train"}
