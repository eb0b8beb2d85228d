"""The port's demos (``lqp_py_tpu_torch.demo``) on the CPU at a small n,
each through ``main([..., "--device", "cpu"])``."""

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from lqp_py_tpu_torch.demo import (demo_box_qp_layer, demo_polish,
                                   demo_solve_box_qp,
                                   demo_solve_box_qp_numpy,
                                   demo_status_reporting)

CPU = ["--device", "cpu"]


def test_demo_solve_box_qp(capsys):
    err = demo_solve_box_qp.main(["--n-x", "24", "--n-batch", "4", *CPU])
    out = capsys.readouterr().out
    assert "converged=True" in out and "backward:" in out
    # Against the native solver at eps 1e-9 where it builds.
    assert err is None or err < 1e-3


def test_demo_box_qp_layer():
    diffs = demo_box_qp_layer.main(["--n-x", "24", "--n-batch", "4", *CPU])
    for name, (dq, dp) in diffs.items():
        assert dq < 1e-4 and dp < 1e-4, name


def test_demo_polish():
    rows = demo_polish.main(CPU)
    iters, err, worst = rows["loose + polish"]
    assert err < 1e-8 and worst < 1e-10
    assert iters < rows["tight eps=1e-12"][0]


def test_demo_status_reporting(capsys):
    sol, trace = demo_status_reporting.main(CPU)
    assert bool(sol.primal_infeasible[1]) and bool(sol.converged[0])
    assert int(sol.iterations) < 20000
    assert trace.shape == (16, 3) and "residual trajectory" in (
        capsys.readouterr().out)


def test_demo_status_reporting_gate_raises(monkeypatch):
    """The demo's assert is a gate: a feasible element 1 fails it."""
    real = demo_status_reporting.problems

    def feasible(device, n=6):
        Q, p, A, b, lb, ub = real(device, n)
        return Q, p, A, b * 0.0, lb, ub
    monkeypatch.setattr(demo_status_reporting, "problems", feasible)
    with pytest.raises(AssertionError, match="infeasible"):
        demo_status_reporting.main(CPU)


def test_demo_solve_box_qp_numpy(capsys):
    dx = demo_solve_box_qp_numpy.main(["--n-x", "30", *CPU])
    assert dx < 1e-5 and "demo OK" in capsys.readouterr().out
