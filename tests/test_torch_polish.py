"""Parity of the port's active-set polish with the JAX package:
``box_penalty_polish`` and ``gen_penalty_polish`` on given active sets, and
``solve_box_qp(polish=True)`` direct, prepared and with acceleration.

float64 on numpy-seeded data.  The polish helpers match to 1e-8: their
penalty systems have condition ~w = 1e6, which amplifies the packages'
different summation orders to a few 1e-9.  Whole solves match x, lams and
nus to 1e-8 with the same accepted elements, and the polished solutions
are gated on ``kkt_residuals`` (the solver-independent oracle), as the
reference's known polish faults ask.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import _polish as jpol
from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import _polish as tpol
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.utils.convert import problem_from_numpy
from lqp_py_tpu_torch.utils.generators import kkt_residuals

LOOSE = dict(eps_abs=1e-4, eps_rel=1e-4)


def _np(data):
    return [None if a is None else np.array(a, np.float64) for a in data]


def _jax(data):
    return [None if a is None else jnp.asarray(a) for a in data]


def _close(t, j, atol, what=""):
    if j is None:
        assert t is None, what
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol,
                               err_msg=what)


def _spd(rng, B, n):
    L = rng.standard_normal((B, 2 * n, n))
    return np.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.1 * np.eye(n)


@pytest.mark.parametrize("with_A", [True, False], ids=["with-A", "no-A"])
def test_box_penalty_polish_matches_jax(with_A):
    """A random active set with infinite bounds off it and two pins (both
    sides active)."""
    rng = np.random.default_rng(0)
    B, n, m = 3, 16, 2
    Q, p = _spd(rng, B, n), rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n)) if with_A else None
    b = rng.standard_normal((B, m)) if with_A else None
    lb, ub = -rng.random((B, n)), rng.random((B, n))
    act_lo, act_hi = rng.random((B, n)) < 0.3, rng.random((B, n)) < 0.3
    act_hi &= ~act_lo
    act_lo[:, :2] = act_hi[:, :2] = True
    lb[:, :2] = ub[:, :2] = 0.25
    lb[~act_lo] = -np.inf
    ub[~act_hi] = np.inf
    args = (Q, p, A, b, lb, ub, act_lo, act_hi)
    j = jpol.box_penalty_polish(*_jax(args))
    t = tpol.box_penalty_polish(*[None if a is None else torch.tensor(a)
                                  for a in args])
    for name in tpol.PolishResult._fields:
        _close(getattr(t, name), getattr(j, name), 1e-8, name)
    np.testing.assert_allclose(t.x[:, :2].numpy(), 0.25, atol=1e-12)


@pytest.mark.parametrize("with_A", [True, False], ids=["with-A", "no-A"])
def test_gen_penalty_polish_matches_jax(with_A):
    rng = np.random.default_rng(1)
    B, n, m, k = 3, 14, 2, 10
    Q, p = _spd(rng, B, n), rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n)) if with_A else None
    b = rng.standard_normal((B, m)) if with_A else None
    G, h = rng.standard_normal((B, k, n)), rng.random((B, k))
    act = rng.random((B, k)) < 0.4
    args = (Q, p, A, b, G, h, act)
    j = jpol.gen_penalty_polish(*_jax(args))
    t = tpol.gen_penalty_polish(*[None if a is None else torch.tensor(a)
                                  for a in args])
    for name in tpol.GenPolishResult._fields:
        _close(getattr(t, name), getattr(j, name), 1e-8, name)


def test_penalty_constants_match_jax():
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        assert tpol._penalty_weight(td) == float(jpol._penalty_weight(jd))
        assert tpol.al_lam_threshold(td) == pytest.approx(
            jpol.al_lam_threshold(jd), rel=1e-12)


def _polished_both(data, **cfg):
    """The JAX and port polished solves, the JAX unpolished one (whose x
    tells which elements the JAX package accepted), and the data."""
    d = _np(data)
    jc = J.BoxQPConfig(**cfg)
    jp = J.solve_box_qp(*_jax(d), config=jc)
    jplain = J.solve_box_qp(*_jax(d), config=dataclasses.replace(
        jc, polish=False))
    tp = T.solve_box_qp(*problem_from_numpy(*d, device="cpu"),
                        config=T.BoxQPConfig(**cfg))
    return jp, jplain, tp, d


def _assert_same_polish(jp, jplain, tp):
    assert tp.iterations == int(jp.iterations)
    jacc = np.any(np.asarray(jp.x) != np.asarray(jplain.x), axis=-1)
    np.testing.assert_array_equal(tp.polished.numpy(), jacc)
    for f in ("x", "z", "lams", "nus"):
        _close(getattr(tp, f), getattr(jp, f), 1e-8, f)


@pytest.mark.parametrize("case", ["create", "hard", "infinite-bounds",
                                  "pinned"])
def test_polished_solve_matches_jax(case):
    if case == "hard":
        data = generate_hard_qp(24, 4, seed=1)
    else:
        data = _np(create_qp_data(30, 4, seed=2, dtype=jnp.float64))
        if case == "infinite-bounds":
            data[4][:, ::3] = -np.inf
            data[5][:, 1::4] = np.inf
            data[2] = data[3] = None
        elif case == "pinned":
            pin = (data[4] + data[5]) / 2
            data[4][:, :4] = data[5][:, :4] = pin[:, :4]
    jp, jplain, tp, d = _polished_both(data, polish=True, **LOOSE)
    _assert_same_polish(jp, jplain, tp)
    assert bool(tp.polished.all())
    tdat = problem_from_numpy(*d, device="cpu")
    res = kkt_residuals(*tdat, tp.x, tp.lams, tp.nus)
    plain = T.solve_box_qp(*tdat, config=T.BoxQPConfig(**LOOSE))
    res_plain = kkt_residuals(*tdat, plain.x, plain.lams, plain.nus)
    for name in res:
        # Polished KKT residuals at machine scale, and never worse than
        # the iterate's, element by element.
        assert float(res[name].max()) < 1e-9, (name, res[name])
        assert bool((res[name] <= res_plain[name] + 1e-12).all()), name


def test_prepared_polish_equals_direct_and_runs_the_leaf(monkeypatch):
    """A prepared polished solve gives the direct one's answer; in float32
    at n=200 the polish factorization is one more pass of the SWEEP leaf
    (2 leaves at 256) beside the solve's own."""
    leaves = []
    orig = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaves.append(1) or orig(X, **kw))
    d = problem_from_numpy(*_np(create_qp_data(200, 3, seed=4,
                                               dtype=jnp.float64)),
                           device="cpu", dtype=torch.float32)
    cfg = T.BoxQPConfig(polish=True, eps_abs=1e-5, eps_rel=1e-5,
                        symmetrize=False)
    direct = T.solve_box_qp(*d, config=cfg)
    n_polished = len(leaves)
    leaves.clear()
    T.solve_box_qp(*d, config=dataclasses.replace(cfg, polish=False))
    assert len(leaves) % 2 == 0 and n_polished == len(leaves) + 2
    prep = T.prepare_box_qp(d.Q, d.A, d.b, d.lb, d.ub, config=cfg)
    served = T.solve_box_qp_prepared(prep, d.p, config=cfg)
    for f in ("x", "z", "lams", "nus", "polished"):
        assert torch.equal(getattr(served, f), getattr(direct, f)), f
    assert bool(direct.polished.any())


@pytest.mark.parametrize("case", ["create", "narrow-box"])
def test_polish_with_acceleration_matches_jax(case):
    """The Anderson path detects the active set by proximity alone and
    pins double-fires of a narrow box at the iterate's z (the counterpart
    of tests/test_polish.py's narrow-box case)."""
    data = _np(create_qp_data(30, 6, seed=0, dtype=jnp.float64))
    if case == "narrow-box":
        data[5][:, :5] = data[4][:, :5] + 1e-3
    jp, jplain, tp, d = _polished_both(data, polish=True, acceleration=5,
                                       **LOOSE)
    assert tp.iterations == int(jp.iterations)
    np.testing.assert_array_equal(
        tp.polished.numpy(),
        np.any(np.asarray(jp.x) != np.asarray(jplain.x), axis=-1))
    for f in ("x", "z", "lams", "nus"):
        # The accelerated iterate carries the Gram solve's amplified
        # rounding (tests/test_torch_anderson.py); the polish re-solves
        # from it.
        _close(getattr(tp, f), getattr(jp, f), 1e-7, f)
    tight = T.solve_box_qp(*problem_from_numpy(*d, device="cpu"),
                           config=T.BoxQPConfig(eps_abs=1e-12, eps_rel=1e-12,
                                                max_iters=50_000))
    e_plain = float((torch.tensor(np.asarray(jplain.x)) - tight.x).abs().max())
    e_pol = float((tp.x - tight.x).abs().max())
    assert e_pol <= e_plain * 1.5 + 1e-10, (e_plain, e_pol)
