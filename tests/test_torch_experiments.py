"""The port's Experiment-1 family, serving and straggler drivers
(``lqp_py_tpu_torch.experiments``) on the CPU at a tiny size.

Each driver runs through ``main([..., "--device", "cpu"])`` (n=16, B=4,
one sim) into ``tmp_path``, and its artifact's keys are held against the
committed JAX artifact's (read, never written).  On the same numpy data,
given to both packages: Experiment 1's sim-0 x per column within 1e-3 of
the JAX column's (f32; the port's f32 factorization takes the recursion
with the plain leaf where JAX takes Cholesky, ROADMAP Queue 3) and
iterations within one check interval (one iteration for the interior
points, which check every iteration); the straggler's ridge step applied
to JAX's hard data within 1e-6 of JAX's ``mixed_batch``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models.box_ip import solve_box_qp_ip as j_solve_box_ip
from lqp_py_tpu.models.box_qp import solve_box_qp_unrolled as j_unrolled
from lqp_py_tpu.models.genqp import solve_qp_gen as j_solve_gen
from lqp_py_tpu.models.optnet import solve_qp_optnet as j_solve_optnet
from lqp_py_tpu.utils.generators import create_qp_data as j_create
from lqp_py_tpu.utils.generators import generate_hard_qp as j_hard
from lqp_py_tpu_torch.experiments import experiment_1 as e1
from _torch_threads import one_torch_thread  # noqa: F401
from lqp_py_tpu_torch.experiments import (experiment_1_hard,
                                          experiment_1_paper,
                                          experiment_serving,
                                          experiment_straggler)
from lqp_py_tpu_torch.utils.convert import problem_from_numpy

REPO = Path(__file__).resolve().parents[1]
N, B, TOL = 16, 4, 1e-5
CPU = ["--device", "cpu"]


def _jax_artifact(name):
    return json.loads((REPO / name).read_text())


def _assert_keys_cover(ours, theirs, where):
    missing = set(theirs) - set(ours)
    assert not missing, f"{where}: keys of the JAX artifact missing {missing}"


def _numpy_problem(gen, n=N, b=B):
    return [np.asarray(a) for a in gen(n, b, seed=0, dtype=jnp.float32)]


def test_experiment_1_main_writes_the_jax_schema(tmp_path, monkeypatch):
    monkeypatch.setattr(e1, "chain_length", lambda n_x: 2)
    e1.main(["--sizes", str(N), "--n-batch", str(B), "--n-sims", "1", *CPU,
             "--out-dir", str(tmp_path)])
    ours = json.loads((tmp_path / e1.ARTIFACT).read_text())
    theirs = _jax_artifact("exp1_results.json")
    _assert_keys_cover(ours, theirs, "top level")
    assert ours["device"] == "cpu" and ours["n_sims"] == 1
    cell = ours["results"][str(N)]
    _assert_keys_cover(cell, theirs["results"]["1000"], "columns")
    for col, rec in theirs["results"]["1000"].items():
        _assert_keys_cover(cell[col], rec, col)
    for col in ("ADMM_FP", "ADMM_KKT", "GenQP", "OptNet_IP", "BoxIP"):
        assert cell[col]["n_converged"] == B, col
    for col in ("ADMM_FP", "ADMM_KKT", "ADMM_Unroll", "GenQP", "OptNet_IP",
                "BoxIP"):
        assert cell[col]["max_dev_x_vs_tight"] < e1.DEV_GATE, col
        assert cell[col]["total"] > 0 and cell[col]["device_total"] > 0
    assert not (tmp_path / "exp1_results.json").exists()


def test_experiment_1_merges_sizes_of_the_same_device(tmp_path):
    old = {"device": "cpu", "tol": TOL, "n_batch": B,
           "results": {"10": {"a": 1}, "16": {"a": 2}}}
    (tmp_path / e1.ARTIFACT).write_text(json.dumps(old))
    merged = e1.merge_results(tmp_path, {16: {"a": 3}}, "cpu", TOL, B)
    assert merged == {10: {"a": 1}, 16: {"a": 3}}
    assert e1.merge_results(tmp_path, {16: {"a": 3}}, "NVIDIA H100, 700 W",
                            TOL, B) == {16: {"a": 3}}


def test_experiment_1_quality_gate_raises():
    x = torch.zeros(2, 3)
    with pytest.raises(AssertionError, match="exceeds"):
        e1.quality_gate("m", x + 1.0, x)
    with pytest.raises(AssertionError, match="converged"):
        e1.quality_gate("m", x, x, converged=torch.tensor([True, False]))
    assert e1.quality_gate("m", x, x, torch.tensor([True, True]), 7) == {
        "max_dev_x_vs_tight": 0.0, "n_converged": 2, "n_problems": 2,
        "iterations": 7}


@pytest.fixture(scope="module")
def exp1_columns():
    """Sim 0's gate solves of every column, in both packages, on the JAX
    generator's f32 problems handed to both."""
    d = _numpy_problem(j_create)
    jd = j_create(N, B, seed=0, dtype=jnp.float32)
    G, h = jd.with_G_h()
    box, gh = tuple(jd), (jd.Q, jd.p, jd.A, jd.b, G, h)
    modes = {
        "ADMM": J.BoxQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False),
        "ADMM_Unroll": J.BoxQPConfig(eps_abs=TOL, eps_rel=TOL, unroll=True,
                                     symmetrize=False, unroll_iters=60,
                                     adaptive_rho=False)}
    gen_cfg = J.GenQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False)
    ip_cfg = J.OptNetConfig(tol=TOL, max_iters=30, symmetrize=False)
    theirs = {}
    s = jax.jit(lambda *a: J.solve_box_qp(*a, modes["ADMM"]))(*box)
    theirs["ADMM"] = (s.x, int(s.iterations),
                      modes["ADMM"].resolved_check_interval(N))
    theirs["ADMM_Unroll"] = (jax.jit(lambda *a: j_unrolled(
        *a, modes["ADMM_Unroll"]))(*box), None, None)
    s = jax.jit(lambda *a: j_solve_gen(*a, config=gen_cfg))(*gh)
    theirs["GenQP"] = (s.x, int(s.iterations), gen_cfg.check_solved)
    s = jax.jit(lambda *a: j_solve_optnet(*a, config=ip_cfg))(*gh)
    theirs["OptNet_IP"] = (s.x, int(s.iterations), 1)
    s = jax.jit(lambda *a: j_solve_box_ip(*a, config=ip_cfg))(*box)
    theirs["BoxIP"] = (s.x, int(s.iterations), 1)
    ours = e1.column_solutions(problem_from_numpy(*d, device="cpu"), TOL)
    return ours, theirs


@pytest.mark.parametrize("column", ["ADMM", "ADMM_Unroll", "GenQP",
                                    "OptNet_IP", "BoxIP"])
def test_experiment_1_column_matches_jax(exp1_columns, column):
    ours, theirs = exp1_columns
    x, converged, iterations = ours[column]
    jx, jit, interval = theirs[column]
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-3)
    if jit is not None:
        assert bool(converged.all())
        assert abs(int(iterations) - jit) <= interval, (iterations, jit)


def test_experiment_1_paper_main_writes_the_jax_schema(tmp_path):
    experiment_1_paper.main(["--n-x", str(N), "--n-batch", str(B),
                             "--n-sims", "1", *CPU, "--out-dir",
                             str(tmp_path)])
    ours = json.loads((tmp_path / experiment_1_paper.ARTIFACT).read_text())
    theirs = _jax_artifact("exp1_paper_results.json")
    _assert_keys_cover(ours, theirs, "top level")
    _assert_keys_cover(ours["protocol"], theirs["protocol"], "protocol")
    _assert_keys_cover(ours["results"], theirs["results"], "columns")
    for col, rec in theirs["results"].items():
        _assert_keys_cover(ours["results"][col], rec, col)
    assert ours["results"]["ADMM_FP_5"]["n_converged"] == B


def test_experiment_1_hard_main_writes_the_jax_schema(tmp_path):
    experiment_1_hard.main(["--sizes", str(N), "--n-batch", str(B),
                            "--n-sims", "1", *CPU, "--out-dir",
                            str(tmp_path)])
    ours = json.loads((tmp_path / experiment_1_hard.ARTIFACT).read_text())
    theirs = _jax_artifact("exp1_hard_results.json")
    _assert_keys_cover(ours, theirs, "top level")
    cell = ours["results"][str(N)]
    _assert_keys_cover(cell, theirs["results"]["500"], "columns")
    assert {"GenQP_gated", "GenQP_aa10", "_GenQP_rescale_all_iters"} <= set(
        cell)
    for key in ("_n_converged", "_BoxIP_n_converged", "_aa10_n_converged",
                "_noadapt_n_converged"):
        assert cell[key] == B, key


def test_experiment_serving_main_writes_the_jax_schema(tmp_path):
    experiment_serving.main(["--n-x", str(N), "--n-batch", str(B),
                             "--steps", "3", *CPU, "--out-dir",
                             str(tmp_path)])
    ours = json.loads((tmp_path / experiment_serving.ARTIFACT).read_text())
    _assert_keys_cover(ours, _jax_artifact("exp_serving_results.json"),
                       "top level")
    for key in ("cold", "warm", "cold_iters", "warm_iters", "fused_iters",
                "genqp_fused_iters"):
        assert len(ours[key]) == 3, key
    # Warm starts from the previous step's solution need fewer iterations.
    assert max(ours["warm_iters"]) <= max(ours["cold_iters"])


def test_experiment_straggler_main_merges_sizes(tmp_path):
    for n in (N, 24):
        experiment_straggler.main(["--n-x", str(n), "--n-batch", str(B),
                                   "--n-hard", "1", "--n-reps", "1", *CPU,
                                   "--out-dir", str(tmp_path)])
    ours = json.loads((tmp_path / experiment_straggler.ARTIFACT).read_text())
    theirs = _jax_artifact("exp_straggler_results.json")
    _assert_keys_cover(ours, theirs, "top level")
    assert set(ours["results"]) == {str(N), "24"}
    for cell in ours["results"].values():
        _assert_keys_cover(cell, theirs["results"]["1000"], "cell")
        for col in ("xla_step", "pallas_step"):
            _assert_keys_cover(cell[col], theirs["results"]["1000"][col],
                               col)
        assert (cell["xla_step"]["n_converged"]
                == cell["pallas_step"]["n_converged"])


def test_straggler_ridge_matches_jax_mixed_batch():
    """The ridge step on JAX's hard data, within 1e-6 of JAX's
    ``mixed_batch`` (f32)."""
    from experiments.experiment_straggler import mixed_batch as j_mixed
    n_hard = 2
    hard = _numpy_problem(j_hard)
    ours = experiment_straggler.ridge_easy(torch.tensor(hard[0]), n_hard)
    theirs = j_mixed(N, B, n_hard)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs[0]), rtol=0,
                               atol=1e-6)
    for a, b in zip(hard[1:], theirs[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
