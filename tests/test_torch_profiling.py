"""The port's profiling helpers (``lqp_py_tpu_torch/utils/profiling.py``)
against the JAX package's: ``timed`` and ``solve_stats`` return the same
keys, ``solve_stats`` the same values on the same solution, and ``trace``
writes a trace file.  On the CPU: ``timed`` takes the host clock there."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqp_py_tpu.utils import profiling as jprof
from lqp_py_tpu.utils.generators import create_qp_data
import lqp_py_tpu as J
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.utils import profiling as tprof
from lqp_py_tpu_torch.utils.convert import (gen_problem_from_numpy,
                                            problem_from_numpy)


def _box_data():
    d = create_qp_data(12, 3, seed=4, dtype=jnp.float64)
    return [np.asarray(a) for a in d]


def test_timed_keys_match_jax():
    x = torch.ones(4)
    theirs = jprof.timed(lambda: jnp.ones(4) * 2, n=3)
    ours = tprof.timed(lambda v: v * 2, x, n=3)
    assert set(ours) == set(theirs)
    assert ours["n"] == 3
    assert 0 <= ours["min_s"] <= ours["median_s"] <= ours["max_s"]


@pytest.mark.parametrize("solver", ["box", "genqp"])
def test_solve_stats_match_jax(solver):
    """Box solutions carry rho (its range is reported), general-QP ones do
    not; float64 on both sides, the same solve."""
    d = _box_data()
    if solver == "box":
        cfg = dict(eps_abs=1e-9, eps_rel=1e-9)
        j = J.solve_box_qp(*(jnp.asarray(a) for a in d),
                           config=J.BoxQPConfig(**cfg))
        t = T.solve_box_qp(*problem_from_numpy(*d, device="cpu"),
                           config=T.BoxQPConfig(**cfg))
    else:
        jd = create_qp_data(12, 3, seed=4, dtype=jnp.float64)
        G, h = (np.asarray(a) for a in jd.with_G_h())
        args = [*d[:4], G, h]
        cfg = dict(eps_abs=1e-9, eps_rel=1e-9)
        j = J.solve_qp_gen(*(jnp.asarray(a) for a in args),
                           config=J.GenQPConfig(**cfg))
        t = T.solve_qp_gen(*gen_problem_from_numpy(*args, device="cpu"),
                           config=T.GenQPConfig(**cfg))
    theirs, ours = jprof.solve_stats(j), tprof.solve_stats(t)
    assert set(ours) == set(theirs)
    assert ("rho_min" in ours) == (solver == "box")
    assert ours["iterations"] == theirs["iterations"]
    assert isinstance(ours["iterations"], int)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-9,
                                   err_msg=k)


def test_force_returns_its_tree_and_trace_writes_a_file(tmp_path):
    tree = {"a": (torch.ones(2), [torch.zeros(3)]), "b": None}
    assert tprof.force(tree) is tree
    with tprof.trace(tmp_path / "logs"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / "logs").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
