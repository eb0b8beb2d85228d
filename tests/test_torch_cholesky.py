"""Parity of the port's Cholesky KKT mode (``kkt_solver="cholesky"``) with
the JAX package: ``factorize_kkt(mode="cholesky")`` and ``kkt_apply``, the
ADMM solve direct and prepared, and what the mode switches off (the
SWEEP leaf and the early-exit step).

float64 on numpy-seeded data: factors and solves within 1e-12, solves of
the ADMM loop within 1e-8 with equal iteration counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.ops import linalg as jlin
from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.ops.kernels import admm_step as gk
from lqp_py_tpu_torch.utils.convert import (prepared_from_numpy,
                                            problem_from_numpy)

FIELDS = ("x", "z", "u", "lams", "nus", "rho")


def _np(data):
    return [None if a is None else np.asarray(a, np.float64) for a in data]


def _jax(data):
    return [None if a is None else jnp.asarray(a) for a in data]


def _close(t, j, atol, what=""):
    if j is None:
        assert t is None, what
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol,
                               err_msg=what)


def _assert_same_solve(js, ts, atol=1e-8):
    assert ts.iterations == int(js.iterations)
    for f in FIELDS:
        _close(getattr(ts, f), getattr(js, f), atol, f)
    for f in ("converged", "primal_infeasible"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("with_A,s_reg", [(False, 0.0), (True, 0.0),
                                          (True, 1e-3)],
                         ids=["no-A", "with-A", "with-A-s_reg"])
def test_factorize_and_apply_match_jax(with_A, s_reg):
    rng = np.random.default_rng(0)
    B, n, m = 3, 12, 3
    L0 = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L0, L0) / (2 * n)
    rho = rng.random(B) + 0.1
    A = rng.standard_normal((B, m, n)) if with_A else None
    b = rng.standard_normal((B, m)) if with_A else None
    r = rng.standard_normal((B, n))
    jf = jlin.factorize_kkt(jnp.asarray(Q), jnp.asarray(rho),
                            None if A is None else jnp.asarray(A),
                            mode="cholesky", s_reg=s_reg)
    tf = tlin.factorize_kkt(torch.tensor(Q), torch.tensor(rho),
                            None if A is None else torch.tensor(A),
                            mode="cholesky", s_reg=s_reg)
    for name in ("L", "W", "Sinv"):
        _close(getattr(tf, name), getattr(jf, name), 1e-12, name)
    assert tf.Hinv is None and tf.P is None and tf.WS is None
    jx, jnu = jlin.kkt_apply(jf, jnp.asarray(r),
                             None if b is None else jnp.asarray(b))
    tx, tnu = tlin.kkt_apply(tf, torch.tensor(r),
                             None if b is None else torch.tensor(b))
    _close(tx, jx, 1e-12, "x")
    _close(tnu, jnu, 1e-12, "nu")
    # The solve is the KKT system's: (Q + rho I) x + A^T nu = r, A x = b.
    H = Q + rho[:, None, None] * np.eye(n)
    res = np.einsum("bij,bj->bi", H, tx.numpy()) - r
    if with_A:
        res += np.einsum("bmi,bm->bi", A, tnu.numpy())
        if not s_reg:
            np.testing.assert_allclose(
                np.einsum("bmi,bi->bm", A, tx.numpy()), b, atol=1e-10)
    if not s_reg:
        assert np.abs(res).max() < 1e-10
    # Outside inverse mode there is no dense step operator.
    assert tlin.kkt_step_operator(tf, None if b is None
                                  else torch.tensor(b)) is None
    assert jlin.kkt_step_operator(jf, None) is None


def test_inverse_mode_kkt_apply_with_materialized_p_matches_jax():
    """kkt_apply through a materialized P (x = P r + W Sinv b), as the JAX
    package computes it."""
    rng = np.random.default_rng(1)
    B, n, m = 2, 10, 2
    L0 = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L0, L0) / (2 * n)
    A, b = rng.standard_normal((B, m, n)), rng.standard_normal((B, m))
    r = rng.standard_normal((B, n))
    jf = jlin.factorize_kkt(jnp.asarray(Q), 0.5, jnp.asarray(A),
                            materialize_p=True)
    tf = tlin.factorize_kkt(torch.tensor(Q), 0.5, torch.tensor(A),
                            materialize_p=True, s_reg=0.0)
    jx, jnu = jlin.kkt_apply(jf, jnp.asarray(r), jnp.asarray(b))
    tx, tnu = tlin.kkt_apply(tf, torch.tensor(r), torch.tensor(b))
    _close(tx, jx, 1e-12, "x")
    _close(tnu, jnu, 1e-12, "nu")


def _both(data, **cfg):
    d = _np(data)
    js = J.solve_box_qp(*_jax(d), config=J.BoxQPConfig(**cfg))
    ts = T.solve_box_qp(*problem_from_numpy(*d, device="cpu"),
                        config=T.BoxQPConfig(**cfg))
    return js, ts


@pytest.mark.parametrize("case", ["create", "hard-adaptive-rho"])
def test_cholesky_solve_matches_jax(case):
    if case == "create":
        data, cfg = create_qp_data(30, 4, dtype=jnp.float64), {}
    else:
        data, cfg = generate_hard_qp(30, 4), dict(eps_abs=1e-6,
                                                 eps_rel=1e-6)
    js, ts = _both(data, kkt_solver="cholesky", **cfg)
    _assert_same_solve(js, ts)
    assert bool(ts.converged.all())
    if case != "create":
        # Adaptive rho refactorized in this mode too: some element ends
        # away from its initial rho.
        from lqp_py_tpu_torch.models import box_qp as tbox
        _, _, rho0 = tbox._prep_h(*problem_from_numpy(*_np(data),
                                                      device="cpu"),
                                  T.BoxQPConfig(**cfg), pad=98)
        assert not torch.allclose(ts.rho, rho0)


def test_cholesky_solve_runs_no_leaf(monkeypatch):
    """In float32 the Cholesky mode factorizes with torch.linalg.cholesky:
    the SWEEP leaf is never called (inverse mode calls it)."""
    leaves = []
    orig = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaves.append(1) or orig(X, **kw))
    d = problem_from_numpy(*_np(create_qp_data(200, 3, seed=2,
                                               dtype=jnp.float64)),
                           device="cpu", dtype=torch.float32)
    cfg = dict(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False)
    chol = T.solve_box_qp(*d, config=T.BoxQPConfig(kkt_solver="cholesky",
                                                   **cfg))
    assert leaves == [] and bool(chol.converged.all())
    inv = T.solve_box_qp(*d, config=T.BoxQPConfig(**cfg))
    assert leaves and bool(inv.converged.all())
    np.testing.assert_allclose(chol.x.numpy(), inv.x.numpy(), atol=2e-3)


def test_prepared_cholesky_matches_direct_and_jax():
    """A Cholesky preparation serves the direct solve's answer, a JAX
    preparation in this mode carries over with its L, and a solve in the
    other mode raises, in both directions."""
    d = _np(create_qp_data(40, 3, seed=3, dtype=jnp.float64))
    Q, p, A, b, lb, ub = d
    cfg = dict(kkt_solver="cholesky", eps_abs=1e-7, eps_rel=1e-7)
    tcfg = T.BoxQPConfig(**cfg)
    td = problem_from_numpy(*d, device="cpu")
    prep = T.prepare_box_qp(td.Q, td.A, td.b, td.lb, td.ub, config=tcfg)
    assert prep.mode == "cholesky" and prep.factors.L is not None
    direct = T.solve_box_qp(*td, config=tcfg)
    served = T.solve_box_qp_prepared(prep, td.p, config=tcfg)
    assert served.iterations == direct.iterations
    for f in FIELDS:
        assert torch.equal(getattr(served, f), getattr(direct, f)), f

    jprep = J.prepare_box_qp(*_jax((Q, A, b, lb, ub)),
                             config=J.BoxQPConfig(**cfg))
    fields = {f.name: getattr(jprep, f.name)
              for f in dataclasses.fields(jprep)}
    fields["factors"] = {f.name: getattr(jprep.factors, f.name)
                         for f in dataclasses.fields(jprep.factors)}
    carried = prepared_from_numpy(
        {k: (v if k in ("mode", "factors") or v is None else np.asarray(v))
         for k, v in fields.items()} | {"factors": {
             k: None if v is None else np.asarray(v)
             for k, v in fields["factors"].items()}}, device="cpu")
    assert carried.mode == "cholesky"
    js = J.solve_box_qp_prepared(jprep, jnp.asarray(p),
                                 config=J.BoxQPConfig(**cfg))
    ts = T.solve_box_qp_prepared(carried, torch.tensor(p), config=tcfg)
    _assert_same_solve(js, ts)

    for mode_prep, mode_solve in (("cholesky", "inverse"),
                                  ("inverse", "cholesky")):
        pr = T.prepare_box_qp(td.Q, td.A, td.b, td.lb, td.ub,
                              config=T.BoxQPConfig(kkt_solver=mode_prep))
        with pytest.raises(ValueError, match="re-run prepare_box_qp"):
            T.solve_box_qp_prepared(pr, td.p, config=T.BoxQPConfig(
                kkt_solver=mode_solve))
    with pytest.raises(ValueError, match="unknown kkt_solver"):
        T.solve_box_qp(*td, config=T.BoxQPConfig(kkt_solver="lu"))


def test_early_exit_step_is_off_in_cholesky_mode(monkeypatch):
    """use_pallas_step is ignored in Cholesky mode, as in the JAX package:
    the plain alignment (128), no early-exit step, the same solve."""
    from lqp_py_tpu_torch.models import box_qp as tbox
    steps = []
    monkeypatch.setattr(tbox, "fused_admm_step",
                        lambda *a, **k: steps.append(1) or gk.fused_admm_step(
                            *a, **k))
    data = create_qp_data(30, 3, seed=4, dtype=jnp.float64)
    js, ts = _both(data, kkt_solver="cholesky", use_pallas_step=True)
    _assert_same_solve(js, ts)
    assert steps == []
    _, plain = _both(data, kkt_solver="cholesky")
    for f in FIELDS:
        assert torch.equal(getattr(ts, f), getattr(plain, f)), f
    td = problem_from_numpy(*_np(data), device="cpu")
    prep = T.prepare_box_qp(td.Q, td.A, td.b, td.lb, td.ub,
                            config=T.BoxQPConfig(kkt_solver="cholesky",
                                                 use_pallas_step=True))
    assert prep.H.shape[-1] == 128 and prep.factors.P is None
