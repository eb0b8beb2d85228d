"""Parity of the port's forward box-QP solve (lqp_py_tpu_torch.models.box_qp)
with the JAX package, direct and prepared.

Problem data comes from the JAX generators (or numpy) as numpy arrays and
is handed to both packages.  In float64 both take the Cholesky inverse and
must agree step for step; in float32 the port runs the Schur recursion
with the plain SWEEP leaf (the algorithm the card runs) while the JAX
package's CPU path takes Cholesky, so the two agree to solve tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import box_qp as tbox
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.utils.generators import (
    generate_hard_qp as generate_hard_qp_t)
from lqp_py_tpu_torch.utils.convert import (prepared_from_numpy,
                                            problem_from_numpy,
                                            solution_from_numpy)

FIELDS = ("x", "z", "u", "lams", "nus", "rho")


def _np(data, dtype):
    return [None if a is None else np.asarray(a, dtype) for a in data]


def _jax(data):
    return [None if a is None else jnp.asarray(a) for a in data]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _both(data, dtype=np.float64, **cfg):
    d = _np(data, dtype)
    js = J.solve_box_qp(*_jax(d), config=J.BoxQPConfig(**cfg))
    ts = T.solve_box_qp(*problem_from_numpy(*d, device="cpu"),
                        config=T.BoxQPConfig(**cfg))
    return js, ts


def _assert_same_solve(js, ts, atol=1e-8):
    assert ts.iterations == int(js.iterations)
    for f in FIELDS:
        a, b = getattr(js, f), getattr(ts, f)
        if a is None:
            assert b is None, f
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol, err_msg=f)
    for f in ("converged", "primal_infeasible"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_f64_create_family_matches_jax():
    js, ts = _both(create_qp_data(50, 8, dtype=jnp.float64))
    _assert_same_solve(js, ts)
    assert bool(ts.converged.all())


def test_f64_hard_family_with_adaptive_rho_matches_jax():
    data = generate_hard_qp(30, 4)
    cfg = dict(eps_abs=1e-6, eps_rel=1e-6)
    js, ts = _both(data, **cfg)
    _assert_same_solve(js, ts)
    # Adaptive rho fired: some element ends away from its initial rho.
    _, _, rho0 = tbox._prep_h(*problem_from_numpy(*_np(data, np.float64),
                                                 device="cpu"),
                              T.BoxQPConfig(**cfg), pad=98)
    assert not torch.allclose(ts.rho, rho0)


@pytest.mark.parametrize("cfg", [
    pytest.param(dict(alpha=1.0, adaptive_rho=False), id="plain-iteration"),
    pytest.param(dict(scale=False, rho=0.3, check_solved=3), id="unscaled"),
    pytest.param(dict(max_iters=7), id="iteration-cap"),
])
def test_f64_config_variants_match_jax(cfg):
    js, ts = _both(create_qp_data(20, 3, seed=1, dtype=jnp.float64), **cfg)
    _assert_same_solve(js, ts)


def test_f64_no_bounds_no_equalities_matches_jax():
    # No finite bound anywhere: rho is forced to 0 and alpha to 1.
    Q, p, *_ = create_qp_data(20, 3, seed=2, dtype=jnp.float64)
    js, ts = _both((Q, p, None, None, None, None))
    _assert_same_solve(js, ts, atol=1e-10)
    assert ts.nus is None and bool(ts.converged.all())
    assert torch.all(ts.rho == 0)


def test_f32_recursion_path_agrees_with_jax(monkeypatch):
    leaf_calls = []
    orig = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaf_calls.append(X.shape)
                        or orig(X, **kw))
    js, ts = _both(create_qp_data(200, 4, dtype=jnp.float32), np.float32,
                   eps_abs=1e-5, eps_rel=1e-5, symmetrize=False)
    assert leaf_calls and all(s == (4, 128, 128) for s in leaf_calls)
    assert ts.x.dtype == torch.float32
    assert bool(ts.converged.all()) and bool(np.all(js.converged))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=2e-3)


def _spd(rng, B, n):
    L = rng.standard_normal((B, 2 * n, n))
    return np.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.5 * np.eye(n)


@pytest.mark.parametrize("case", ["crossed-bounds", "inconsistent-equality"])
def test_infeasibility_flags_match_jax(case):
    rng = np.random.default_rng(7)
    B, n = 2, 6
    Q, p = _spd(rng, B, n), rng.standard_normal((B, n))
    lb, ub = -np.ones((B, n)), np.ones((B, n))
    A = b = None
    if case == "crossed-bounds":
        lb[1, 2], ub[1, 2] = 0.5, -0.5            # element 1's box is empty
    else:
        A = np.ones((B, 1, n))
        b = np.array([[2.0], [10.0]])              # sum(x) = 10 > n * 1
    cfg = dict(eps_abs=1e-6, eps_rel=1e-6, max_iters=20000)
    js, ts = _both((Q, p, A, b, lb, ub), **cfg)
    np.testing.assert_array_equal(ts.primal_infeasible.numpy(), [False, True])
    _assert_same_solve(js, ts)


def test_warm_start_and_residual_trace_match_jax():
    data = _np(create_qp_data(50, 4, seed=3, dtype=jnp.float64), np.float64)
    cfg = dict(residual_trace=5, eps_abs=1e-7, eps_rel=1e-7)
    js0, ts0 = _both(data, **cfg)
    Q, p, A, b, lb, ub = data
    p2 = p + 0.05 * np.random.default_rng(4).standard_normal(p.shape)
    js = J.solve_box_qp(*_jax((Q, p2, A, b, lb, ub)),
                        config=J.BoxQPConfig(**cfg), warm_start=js0)
    ts = T.solve_box_qp(*problem_from_numpy(Q, p2, A, b, lb, ub,
                                           device="cpu"),
                        config=T.BoxQPConfig(**cfg), warm_start=ts0)
    _assert_same_solve(js, ts)
    assert ts.iterations < ts0.iterations
    for j, t in ((js0, ts0), (js, ts)):
        np.testing.assert_allclose(t.residual_trace.numpy(),
                                   np.asarray(j.residual_trace), rtol=1e-9,
                                   atol=1e-12)
    # A solve longer than the ring keeps the last 5 checks, oldest first.
    its = ts0.residual_trace[:, 0]
    assert torch.all(its[1:] > its[:-1]) and its[-1] == ts0.iterations


def test_verbose_prints_each_check_and_short_trace_keeps_empty_rows(capsys):
    Q, p, A, b, lb, ub = create_qp_data(20, 2, seed=5, dtype=jnp.float64)
    sol = T.solve_box_qp(*problem_from_numpy(Q, p, A, b, lb, ub,
                                            device="cpu"),
                         config=T.BoxQPConfig(verbose=True,
                                              residual_trace=16))
    lines = capsys.readouterr().out.splitlines()
    assert lines and lines[-1].startswith(f"iter={sol.iterations} ")
    its = sol.residual_trace[:, 0]
    assert its[:len(lines)].tolist() == [
        float(line.split()[0].split("=")[1]) for line in lines]
    assert torch.all(its[len(lines):] == -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prepared_solve_equals_direct_solve(dtype):
    Q, p, A, b, lb, ub = problem_from_numpy(
        *_np(create_qp_data(200, 4, seed=6, dtype=jnp.float64), np.float64),
        dtype=dtype, device="cpu")
    cfg = T.BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5)
    direct = T.solve_box_qp(Q, p, A, b, lb, ub, config=cfg)
    prep = T.prepare_box_qp(Q, A, b, lb, ub, config=cfg)
    served = T.solve_box_qp_prepared(prep, p, config=cfg)
    assert served.iterations == direct.iterations
    for f in FIELDS:
        assert torch.equal(getattr(served, f), getattr(direct, f)), f
    # A warm-started follow-up request converges in fewer iterations.
    nxt = T.solve_box_qp_prepared(prep, p * 1.01, config=cfg,
                                  warm_start=served)
    assert bool(nxt.converged.all()) and nxt.iterations < direct.iterations


def _prepared_fields(jprep):
    """A JAX BoxQPPrepared as the mapping of numpy fields that
    ``prepared_from_numpy`` takes."""
    fields = {k: (None if v is None else np.asarray(v))
              for k, v in _fields(jprep).items()
              if k not in ("factors", "mode")}
    fields["mode"] = jprep.mode
    fields["factors"] = {k: None if v is None else np.asarray(v)
                         for k, v in _fields(jprep.factors).items()}
    return fields


def test_state_carried_over_from_jax():
    """A JAX BoxQPPrepared and a JAX solution, carried over as numpy,
    give the JAX prepared solve's answer."""
    Q, p, A, b, lb, ub = _np(create_qp_data(50, 4, seed=8,
                                            dtype=jnp.float64), np.float64)
    cfg = dict(eps_abs=1e-6, eps_rel=1e-6)
    jprep = J.prepare_box_qp(*_jax((Q, A, b, lb, ub)),
                             config=J.BoxQPConfig(**cfg))
    tprep = prepared_from_numpy(_prepared_fields(jprep), device="cpu")

    js0 = J.solve_box_qp_prepared(jprep, jnp.asarray(p),
                                  config=J.BoxQPConfig(**cfg))
    ts0 = T.solve_box_qp_prepared(tprep, torch.tensor(p),
                                  config=T.BoxQPConfig(**cfg))
    _assert_same_solve(js0, ts0, atol=1e-9)

    # Warm start from the JAX solution itself, carried over.
    warm = solution_from_numpy({k: None if v is None else np.asarray(v)
                                for k, v in _fields(js0).items()},
                               device="cpu")
    assert warm.iterations == int(js0.iterations)
    p2 = p * 1.02
    js = J.solve_box_qp_prepared(jprep, jnp.asarray(p2),
                                 config=J.BoxQPConfig(**cfg), warm_start=js0)
    ts = T.solve_box_qp_prepared(tprep, torch.tensor(p2),
                                 config=T.BoxQPConfig(**cfg), warm_start=warm)
    _assert_same_solve(js, ts, atol=1e-9)

    # A preparation for the early-exit step carries its materialized P.
    cfg_e = dict(cfg, use_pallas_step=True)
    jprep_e = J.prepare_box_qp(*_jax((Q, A, b, lb, ub)),
                               config=J.BoxQPConfig(**cfg_e))
    tprep_e = prepared_from_numpy(_prepared_fields(jprep_e),
                                  device="cpu")
    assert tprep_e.factors.P.shape == (4, 256, 256)
    js_e = J.solve_box_qp_prepared(jprep_e, jnp.asarray(p),
                                   config=J.BoxQPConfig(**cfg_e))
    ts_e = T.solve_box_qp_prepared(tprep_e, torch.tensor(p),
                                   config=T.BoxQPConfig(**cfg_e))
    _assert_same_solve(js_e, ts_e, atol=1e-8)


@pytest.mark.parametrize("prep_early,solve_early", [(False, True),
                                                    (True, False)],
                         ids=["grow-to-256", "slice-to-128"])
def test_prepared_at_other_alignment_equals_direct_solve(prep_early,
                                                         solve_early):
    """n=300 pads to 384 at the plain alignment and to 512 for the
    early-exit step; a preparation made for one serves the other (the
    cached operand and factors are resized, P built where missing) and
    gives the direct solve of the solve-time config."""
    Q, p, A, b, lb, ub = problem_from_numpy(
        *_np(create_qp_data(300, 3, seed=21, dtype=jnp.float64), np.float64),
        device="cpu")
    base = dict(eps_abs=1e-8, eps_rel=1e-8)
    prep = T.prepare_box_qp(Q, A, b, lb, ub, config=T.BoxQPConfig(
        use_pallas_step=prep_early, **base))
    assert prep.H.shape[-1] == (512 if prep_early else 384)
    assert (prep.factors.P is not None) == prep_early
    cfg = T.BoxQPConfig(use_pallas_step=solve_early, **base)
    direct = T.solve_box_qp(Q, p, A, b, lb, ub, config=cfg)
    served = T.solve_box_qp_prepared(prep, p, config=cfg)
    assert bool(direct.converged.all())
    assert served.iterations == direct.iterations
    np.testing.assert_allclose(served.x.numpy(), direct.x.numpy(),
                               rtol=1e-9, atol=1e-10)


def test_generate_hard_qp_structure():
    n, B = 50, 3
    Q, p, A, b, lb, ub = generate_hard_qp_t(n, B, seed=4, device="cpu")
    m = round(n ** 0.5)
    assert Q.shape == (B, n, n) and A.shape == (B, m, n)
    assert p.shape == lb.shape == ub.shape == (B, n) and b.shape == (B, m)
    assert Q.dtype == torch.float64
    assert bool((A != 0).any(dim=-1).all()), "an all-zero equality row"
    assert bool((lb < ub).all())
    assert torch.equal(Q, Q.mT)
    assert bool((torch.linalg.eigvalsh(Q) >= 1e-2 - 1e-9).all())
    # Same seed, same data; another seed, other data.
    assert all(torch.equal(a, c) for a, c in
               zip((Q, p, A, b, lb, ub), generate_hard_qp_t(n, B, seed=4,
                                                         device="cpu")))
    assert not torch.equal(Q, generate_hard_qp_t(n, B, seed=5, device="cpu").Q)
