"""Parity of the port's box-structured interior point with the JAX package:
``solve_box_qp_ip`` with and without equality rows, polish on and off, and
``boxqp_ip``'s KKT implicit gradients of all six inputs in both layouts.

float64 on numpy-seeded data at tol 1e-8 (away from the d_cap = 1e16 end):
both packages factor by Cholesky, so x and nus match to 1e-8, lams to 1e-6
relative, and the iteration counts and converged masks are equal.  The
JAX results are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import box_ip as jbip
from lqp_py_tpu.utils.generators import create_qp_data
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import box_ip as tbip
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.utils.convert import problem_from_numpy

CFG = dict(tol=1e-8, max_iters=60)
CASES = {"with-A": dict(), "with-A-no-polish": dict(polish=False),
         "no-A": dict()}


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _data(case, n=30, B=4, seed=0):
    d = [None if a is None else np.array(a, np.float64)
         for a in create_qp_data(n, B, seed=seed, dtype=jnp.float64)]
    if case == "no-A":
        d[2] = d[3] = None
    return d


@pytest.fixture(scope="module")
def jax_solves():
    out = {}
    for case, kw in CASES.items():
        d = _data(case)
        out[case] = (d, jbip.solve_box_qp_ip(*_jax(d), config=J.OptNetConfig(
            **CFG, **kw)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_solve_box_qp_ip_matches_jax(jax_solves, case):
    d, j = jax_solves[case]
    t = T.solve_box_qp_ip(*problem_from_numpy(*d, device="cpu"),
                          config=T.OptNetConfig(**CFG, **CASES[case]))
    assert t.iterations == int(j.iterations)
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    assert bool(t.converged.all())
    for f in ("x", "z", "u", "nus", "rho"):
        if getattr(j, f) is None:
            assert getattr(t, f) is None, f
            continue
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_allclose(t.lams.numpy(), np.asarray(j.lams),
                               rtol=1e-6, atol=0)
    # The last residuals sit at rounding level (~1e-15): held absolutely.
    for f in ("primal_residual", "dual_residual"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=1e-12, err_msg=f)


@pytest.fixture(scope="module")
def jax_grads():
    d = _data("with-A", n=10, B=2, seed=3)
    w = np.random.default_rng(4).standard_normal(d[1].shape)
    cfg = J.OptNetConfig(tol=1e-10, max_iters=80)

    def loss(*args):
        return jnp.sum(jnp.asarray(w) * jbip.boxqp_ip(*args, config=cfg))

    g = jax.grad(loss, argnums=tuple(range(6)))(*_jax(d))
    return d, w, [np.asarray(a) for a in g]


@pytest.mark.parametrize("layout", ["flat", "column"])
def test_boxqp_ip_gradients_match_jax(jax_grads, layout):
    """d/d(Q, p, A, b, lb, ub) of sum(w * x); "column" passes p, b, lb and
    ub as (B, n, 1) and gets x and their gradients in that layout."""
    d, w, jg = jax_grads
    ts = [torch.tensor(a, requires_grad=True) for a in d]
    args = list(ts)
    if layout == "column":
        args = [a if i in (0, 2) else a[..., None] for i, a in enumerate(ts)]
    x = T.boxqp_ip(*args, config=T.OptNetConfig(tol=1e-10, max_iters=80))
    assert x.shape == args[1].shape
    torch.sum(torch.tensor(w) * x.reshape(w.shape)).backward()
    for name, t, g in zip("Q p A b lb ub".split(), ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-8,
                                   err_msg=name)


def test_boxqp_ip_builds_dQ_and_dA_only_when_asked(monkeypatch):
    """With only p requiring grad, the backward asks for neither outer
    product; the dp it returns is the full backward's."""
    d = problem_from_numpy(*_data("with-A", n=8, B=2), device="cpu")
    calls = []
    kkt = tbip.bgrads.box_qp_grad_kkt

    def spy(*args, **kw):
        calls.append((kw["want_dQ"], kw["want_dA"]))
        return kkt(*args, **kw)

    monkeypatch.setattr(tbip.bgrads, "box_qp_grad_kkt", spy)
    cfg = T.OptNetConfig(**CFG)
    grads = {}
    for want in (False, True):
        p = d.p.clone().requires_grad_(True)
        Q = d.Q.clone().requires_grad_(want)
        A = d.A.clone().requires_grad_(want)
        T.boxqp_ip(Q, p, A, d.b, d.lb, d.ub, config=cfg).sum().backward()
        assert (Q.grad is not None) == want and (A.grad is not None) == want
        grads[want] = p.grad
    assert calls == [(False, False), (True, True)]
    assert torch.equal(grads[False], grads[True])


def test_float32_box_ip_recursion_agrees_with_jax_cholesky(monkeypatch):
    """float32 at n=130: the port's factorizations take the recursion with
    the plain SWEEP leaf (n padded to 256, two leaves each), the JAX
    package's on the CPU take Cholesky; the two routes agree to solve
    accuracy, not step for step."""
    d = [a.astype(np.float32) for a in _data("with-A", n=130, B=3, seed=5)]
    kw = dict(tol=1e-5, max_iters=30, symmetrize=False)
    j = jbip.solve_box_qp_ip(*_jax(d), config=J.OptNetConfig(**kw))
    leaves = []
    leaf = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaves.append(1) or leaf(X, **kw))
    t = T.solve_box_qp_ip(*problem_from_numpy(*d, device="cpu"),
                          config=T.OptNetConfig(**kw))
    assert t.x.dtype == torch.float32 and bool(t.converged.all())
    # One factorization at init, one per iteration, one per polish round.
    assert len(leaves) == 2 * (1 + t.iterations + 2)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-3)

