"""Parity of the port's equality-constrained and unconstrained solvers
(``models/eqcon.py``, ``models/uncon.py``) with the JAX package: solutions,
duals and gradients, the (B, n, 1) layout, the A=None fallback and the
forward's refusal of A=None.

float64 on numpy-seeded data, within 1e-10 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import eqcon as jeq
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import eqcon as teq

ATOL = 1e-10


def _data(n=10, B=3, m=2, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.2 * np.eye(n)
    Q = Q + 0.01 * rng.standard_normal((B, n, n))   # not quite symmetric
    return (Q, rng.standard_normal((B, n)), rng.standard_normal((B, m, n)),
            rng.standard_normal((B, m)))


def _close(t, j, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=ATOL, err_msg=what)


def test_solves_match_jax():
    Q, p, A, b = _data()
    j = J.solve_qp_eqcon(*map(jnp.asarray, (Q, p, A, b)))
    t = T.solve_qp_eqcon(*map(torch.tensor, (Q, p, A, b)))
    assert isinstance(t, T.EqQPSolution)
    _close(t.x, j.x, "x")
    _close(t.nus, j.nus, "nus")
    # The KKT system of the symmetrized Q holds.
    Qs = 0.5 * (Q + Q.transpose(0, 2, 1))
    stat = (np.einsum("bij,bj->bi", Qs, t.x.numpy()) + p
            + np.einsum("bmi,bm->bi", A, t.nus.numpy()))
    assert np.abs(stat).max() < 1e-10
    assert np.abs(np.einsum("bmi,bi->bm", A, t.x.numpy()) - b).max() < 1e-10
    ju = J.solve_qp_uncon(jnp.asarray(Q), jnp.asarray(p))
    tu = T.solve_qp_uncon(torch.tensor(Q), torch.tensor(p))
    _close(tu.x, ju.x, "uncon x")
    assert tu.nus is None and ju.nus is None


@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_eqcon_gradients_match_jax(layout):
    Q, p, A, b = _data(seed=1)
    if layout == "3d":
        p, b = p[..., None], b[..., None]
    w = np.random.default_rng(2).standard_normal(p.shape)

    def jl(Q, p, A, b):
        return jnp.sum(jnp.asarray(w) * J.qp_eqcon(Q, p, A, b))

    jx = J.qp_eqcon(*map(jnp.asarray, (Q, p, A, b)))
    jg = jax.grad(jl, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (Q, p, A, b)))
    tt = [torch.tensor(a, requires_grad=True) for a in (Q, p, A, b)]
    tx = T.qp_eqcon(*tt)
    assert tuple(tx.shape) == np.shape(jx) == p.shape
    _close(tx, jx, "x")
    tg = torch.autograd.grad((torch.tensor(w) * tx).sum(), tt)
    for name, t, j in zip("QpAb", tg, jg):
        assert tuple(t.shape) == np.shape(j), name
        _close(t, j, f"d{name}")


@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_uncon_gradients_match_jax(layout):
    Q, p, _, _ = _data(seed=3)
    if layout == "3d":
        p = p[..., None]
    w = np.random.default_rng(4).standard_normal(p.shape)
    jg = jax.grad(lambda Q, p: jnp.sum(jnp.asarray(w) * J.qp_uncon(Q, p)),
                  argnums=(0, 1))(jnp.asarray(Q), jnp.asarray(p))
    tt = [torch.tensor(a, requires_grad=True) for a in (Q, p)]
    tx = T.qp_uncon(*tt)
    assert tuple(tx.shape) == p.shape
    tg = torch.autograd.grad((torch.tensor(w) * tx).sum(), tt)
    for name, t, j in zip("Qp", tg, jg):
        assert tuple(t.shape) == np.shape(j), name
        _close(t, j, f"d{name}")


def test_eqcon_without_A_falls_back_to_uncon():
    Q, p, _, _ = _data(seed=5)
    tQ, tp = torch.tensor(Q), torch.tensor(p)
    a = T.solve_qp_eqcon(tQ, tp)
    u = T.solve_qp_uncon(tQ, tp)
    assert a.nus is None and torch.equal(a.x, u.x)
    pq = tp.clone().requires_grad_(True)
    x = T.qp_eqcon(tQ, pq, None, None)
    assert torch.equal(x, T.qp_uncon(tQ, tp))
    # Differentiated, the port's fallback is qp_uncon's gradient.  The JAX
    # package's custom VJP reaches _fwd, which raises for A=None.
    (g,) = torch.autograd.grad(x.sum(), (pq,))
    jg = jax.grad(lambda p: jnp.sum(J.qp_uncon(jnp.asarray(Q), p)))(
        jnp.asarray(p))
    _close(g, jg, "dp")
    with pytest.raises(ValueError, match="use qp_uncon"):
        jax.grad(lambda p: jnp.sum(J.qp_eqcon(jnp.asarray(Q), p, None,
                                              None)))(jnp.asarray(p))


def test_forward_refuses_A_none():
    Q, p, _, _ = _data(seed=6)
    with pytest.raises(ValueError, match="use qp_uncon") as theirs:
        jeq._fwd(jnp.asarray(Q), jnp.asarray(p), None, None)
    with pytest.raises(ValueError, match=str(theirs.value)):
        teq._fwd(torch.tensor(Q), torch.tensor(p), None, None)


def test_eqcon_f32_runs_no_leaf(monkeypatch):
    """The Cholesky path never reaches the SWEEP leaf, in float32 either."""
    from lqp_py_tpu_torch.ops import linalg as tlin
    calls = []
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X: calls.append(1) or X)
    Q, p, A, b = (torch.tensor(a, dtype=torch.float32)
                  for a in _data(n=200, B=2, m=3, seed=7))
    Q.requires_grad_(True)
    x = T.qp_eqcon(Q, p, A, b)
    (gQ,) = torch.autograd.grad(x.sum(), (Q,))
    assert calls == [] and bool(torch.isfinite(gQ).all())
    x64 = T.solve_qp_eqcon(*(t.detach().double() for t in (Q, p, A, b))).x
    assert float((x.detach().double() - x64).abs().max()) < 1e-3
