"""Parity of the port's general interior point with the JAX package:
``solve_qp_optnet`` in condensed and Schur modes, with and without
equality rows, on box and general-inequality data, with refinement and the
'mean' stopping rule, the ``G=None`` fallback, and ``optnet_grads`` in both
modes fed the JAX package's own residuals and Schur factors through the
converters.

float64 on numpy-seeded data at tol 1e-8: both packages factor by
Cholesky, so x and nus match to 1e-8, lams and slacks to 1e-6 relative,
gradients to 1e-8, and the iteration counts and converged masks are
equal.  The JAX solves are computed once per module.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import optnet as jon
from lqp_py_tpu.utils.generators import create_qp_data
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import optnet as ton
from lqp_py_tpu_torch.nn import OptNetModule
from lqp_py_tpu_torch.utils.convert import (gen_problem_from_numpy,
                                            ip_factors_from_numpy,
                                            qp_solution_from_numpy)

BASE = dict(tol=1e-8, max_iters=60)
# (data, equality rows, config): 'auto' is condensed on the box (ni = 2n)
# and Schur on the general data (ni < n).  The condensed factor of general
# inequalities, Q + G' diag(d) G, has a condition number growing with
# d = z/s: at tol 1e-8 it reaches the d_cap = 1e16 end, where both
# packages return NaN in x (ROADMAP Queue 3), so that case runs at 1e-7.
CASES = {
    "box-condensed": ("box", True, dict()),
    "box-schur": ("box", True, dict(factor="schur")),
    "box-condensed-no-A": ("box", False, dict()),
    "general-schur": ("general", True, dict()),
    "general-condensed": ("general", True, dict(factor="condensed",
                                                tol=1e-7)),
    "general-schur-no-A": ("general", False, dict()),
    "box-refine-mean": ("box", True, dict(refine_steps=1, reduce="mean")),
}


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _box():
    d = create_qp_data(30, 4, seed=0, dtype=jnp.float64)
    G, h = d.with_G_h()
    return [np.array(a, np.float64) for a in (d.Q, d.p, d.A, d.b, G, h)]


def _general():
    """Random inequalities around a strictly feasible point
    (tests/test_optnet.py's construction, from numpy)."""
    rng = np.random.default_rng(2)
    B, n, ni, m = 3, 12, 8, 2
    L = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.1 * np.eye(n)
    p = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    x0 = rng.standard_normal((B, n))
    G = rng.standard_normal((B, ni, n))
    h = np.einsum("bki,bi->bk", G, x0) + rng.uniform(0.5, 1.5, (B, ni))
    return [Q, p, A, np.einsum("bmi,bi->bm", A, x0), G, h]


def _problem(data, with_A):
    d = _box() if data == "box" else _general()
    if not with_A:
        d[2] = d[3] = None
    return d


@pytest.fixture(scope="module")
def jax_solves():
    """Each case's data and the JAX package's (solution, IPFactors)."""
    out = {}
    for case, (data, with_A, kw) in CASES.items():
        d = _problem(data, with_A)
        out[case] = (d, jon._solve_qp_optnet_full(
            *_jax(d), J.OptNetConfig(**{**BASE, **kw})))
    return out


def _close(t, j, what, rtol=0.0, atol=1e-8):
    if j is None:
        assert t is None, what
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_solve_qp_optnet_matches_jax(jax_solves, case):
    d, (j, jf) = jax_solves[case]
    t, tf = ton._solve_qp_optnet_full(
        *gen_problem_from_numpy(*d, device="cpu"),
        T.OptNetConfig(**{**BASE, **CASES[case][2]}))
    assert (tf is None) == (jf is None)
    assert t.iterations == int(j.iterations)
    # 'mean' stops on the batch mean: not every element need converge.
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    for f in ("x", "nus"):
        _close(getattr(t, f), getattr(j, f), f)
    for f in ("lams", "slacks"):
        _close(getattr(t, f), getattr(j, f), f, rtol=1e-6, atol=0.0)
    # The last residuals sit below the stopping tolerance, at rounding
    # level amplified by d (up to 3x apart on the general condensed case):
    # held to the tolerance.
    tol = {**BASE, **CASES[case][2]}["tol"]
    for f in ("primal_residual", "dual_residual"):
        _close(getattr(t, f), getattr(j, f), f, atol=tol)
    if tf is not None:
        for name in ton.IPFactors._fields:
            _close(getattr(tf, name), getattr(jf, name), name)


@pytest.mark.parametrize("case", ["box-condensed", "general-schur",
                                  "general-schur-no-A"])
def test_optnet_grads_on_jax_residuals_match_jax(jax_solves, case):
    """The port's backward fed the JAX forward's residuals (and, in Schur
    mode, its IPFactors) through the converters: all six gradients."""
    d, (j, jf) = jax_solves[case]
    Q, _p, A, _b, G, _h = d
    w = np.random.default_rng(7).standard_normal(d[1].shape)
    jg = jon.optnet_grads(jnp.asarray(w), j.x, j.lams, j.slacks, j.nus,
                          *_jax((Q, A, G)), jf, 1e-6)
    fields = ("x", "lams", "slacks", "nus", "iterations", "primal_residual",
              "dual_residual", "converged")
    sol = qp_solution_from_numpy({k: None if getattr(j, k) is None
                                  else np.asarray(getattr(j, k))
                                  for k in fields}, device="cpu")
    tf = None if jf is None else ip_factors_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in jf._asdict().items()}, device="cpu")
    Qt, At, Gt = gen_problem_from_numpy(Q, None, A, None, G, None,
                                        device="cpu")[::2]
    tg = ton.optnet_grads(torch.tensor(w), sol.x, sol.lams, sol.slacks,
                          sol.nus, Qt, At, Gt, tf, 1e-6)
    for name, a, b in zip("dQ dp dA db dG dh".split(), tg, jg):
        _close(a, b, name)


@pytest.mark.parametrize("case", ["box-condensed", "general-schur"])
def test_qp_optnet_autograd_is_optnet_grads(jax_solves, case, monkeypatch):
    """The layer's gradients are ``optnet_grads`` on its own forward's
    residuals (Schur mode: its own IPFactors), with the multipliers of its
    accepted polish where the JAX package's layer keeps the IP's z
    (``_solve_ip``); dQ, dA and dG are built only for inputs that require
    grad."""
    d = jax_solves[case][0]
    w = torch.tensor(np.random.default_rng(8).standard_normal(d[1].shape))
    cfg = T.OptNetConfig(**BASE)
    prob = gen_problem_from_numpy(*d, device="cpu")
    sol, f, lams = ton._solve_ip(*prob, cfg)
    want = ton.optnet_grads(w, sol.x, lams, sol.slacks, sol.nus,
                            prob[0], prob[2], prob[4], f, cfg.int_reg)
    ts = [t.clone().requires_grad_(True) for t in prob]
    (w * T.qp_optnet(*ts, config=cfg)).sum().backward()
    for name, t, g in zip("dQ dp dA db dG dh".split(), ts, want):
        torch.testing.assert_close(t.grad, g, rtol=0, atol=1e-12, msg=name)
    p = prob[1].clone().requires_grad_(True)
    calls = []
    grads = ton.optnet_grads

    def spy(*args, **kw):
        calls.append((kw["want_dQ"], kw["want_dA"], kw["want_dG"]))
        return grads(*args, **kw)

    monkeypatch.setattr(ton, "optnet_grads", spy)
    (w * OptNetModule(cfg)(prob[0], p, *prob[2:])).sum().backward()
    assert calls == [(False, False, False)]
    torch.testing.assert_close(p.grad, want[1], rtol=0, atol=1e-12)


def test_no_inequalities_fall_back_to_eqcon():
    """G=None: the direct equality-constrained solve, forward against the
    JAX package and gradients equal to ``qp_eqcon``'s."""
    Q, p, A, b = _box()[:4]
    cfg = dict(BASE)
    j = jon.solve_qp_optnet(*_jax((Q, p, A, b)), config=J.OptNetConfig(**cfg))
    t = T.solve_qp_optnet(*gen_problem_from_numpy(Q, p, A, b, device="cpu")[
        :4], config=T.OptNetConfig(**cfg))
    assert t.iterations == 0 and bool(t.converged.all())
    assert tuple(t.lams.shape) == tuple(t.slacks.shape) == (4, 0)
    _close(t.x, j.x, "x")
    _close(t.nus, j.nus, "nus")
    ts = [torch.tensor(a, requires_grad=True) for a in (Q, p, A, b)]
    us = [torch.tensor(a, requires_grad=True) for a in (Q, p, A, b)]
    T.qp_optnet(*ts).square().sum().backward()
    T.qp_eqcon(*us).square().sum().backward()
    for a, b_ in zip(ts, us):
        assert torch.equal(a.grad, b_.grad)


def test_unknown_factor_mode_raises_like_jax():
    d = _box()
    with pytest.raises(ValueError) as theirs:
        jon.solve_qp_optnet(*_jax(d), config=J.OptNetConfig(factor="lu"))
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        T.solve_qp_optnet(*gen_problem_from_numpy(*d, device="cpu"),
                          config=T.OptNetConfig(factor="lu"))
