"""Parity of the port's unrolled solve with the JAX package: the
differentiable scaling (``scale_problem``, ``identity_scaling``), the
cached-factor KKT solve (``kkt_solve_cached``) and
``solve_box_qp_unrolled`` through ``boxqp(unroll=True)``.

Everything runs in float64 on numpy-seeded data, where both packages take
Cholesky and agree step for step: values and gradients within 1e-10
(scaling, KKT solve) and 1e-9 (whole unrolled solves) absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.ops import linalg as jlin
from lqp_py_tpu.ops import scaling as jsca
from lqp_py_tpu.utils.generators import create_qp_data
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import box_qp as tbox
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.ops import scaling as tsca

NAMES = ("Q", "p", "A", "b", "lb", "ub")


def _np(data):
    return [None if a is None else np.asarray(a, np.float64) for a in data]


def _close(t, j, atol, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol, err_msg=what)


def _spd(rng, B, n):
    L = rng.standard_normal((B, 2 * n, n))
    return np.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.5 * np.eye(n)


def _scaling_inputs(seed=0, B=3, n=12, m=2):
    rng = np.random.default_rng(seed)
    Q = _spd(rng, B, n)
    return [Q, rng.standard_normal((B, n)), rng.standard_normal((B, m, n)),
            rng.standard_normal((B, m)), -1.0 - rng.random((B, n)),
            1.0 + rng.random((B, n))]


@pytest.mark.parametrize("beta,pad", [(None, 0), (None, 4), (0.3, 0)],
                         ids=["auto-beta", "auto-beta-padded", "fixed-beta"])
def test_scale_problem_values_and_vjp_match_jax(beta, pad):
    """Every output of ``scale_problem`` and the VJP with respect to every
    input, for random cotangents on every output (jax.vjp against
    torch.autograd.grad)."""
    args = _scaling_inputs()
    j_out, j_vjp = jax.vjp(
        lambda *a: jsca.scale_problem(*a, beta=beta, pad=pad),
        *[jnp.asarray(a) for a in args])
    t_in = [torch.tensor(a, requires_grad=True) for a in args]
    t_out = tsca.scale_problem(*t_in, beta=beta, pad=pad)
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(np.shape(o)) for o in j_out]
    for name, t, j in zip(tsca.ScaledProblem._fields, t_out, j_out):
        _close(t, j, 1e-12, name)
    j_grads = j_vjp(type(j_out)(*[jnp.asarray(c) for c in cots]))
    t_grads = torch.autograd.grad(
        sum((o * torch.tensor(c)).sum() for o, c in zip(t_out, cots)), t_in)
    for name, t, j in zip(NAMES, t_grads, j_grads):
        _close(t, j, 1e-10, f"d{name}")


def test_scaling_gradient_splits_tied_column_maxima_like_jax():
    """A column whose inf-norm is attained twice (Q[i,j] = Q[j,j]): amax
    splits the gradient between the ties as jnp.max does."""
    args = _scaling_inputs(seed=2, B=2, n=6)
    Q = args[0]
    Q[:, 1, 3] = Q[:, 3, 1] = Q[:, 3, 3] = np.abs(Q).max() + 1.0
    g_j = jax.grad(lambda Q: jnp.sum(
        jsca.scale_problem(Q, *map(jnp.asarray, args[1:])).D ** 3))(
            jnp.asarray(Q))
    Qt = torch.tensor(Q, requires_grad=True)
    (g_t,) = torch.autograd.grad(
        (tsca.scale_problem(Qt, *map(torch.tensor, args[1:])).D ** 3).sum(),
        (Qt,))
    _close(g_t, g_j, 1e-12)
    assert g_t[0, 1, 3] != 0 and g_t[0, 1, 3] == g_t[0, 3, 3]


@pytest.mark.parametrize("pad", [0, 5])
def test_identity_scaling_matches_jax(pad):
    args = _scaling_inputs(seed=3)
    j = jsca.identity_scaling(*[jnp.asarray(a) for a in args], pad=pad)
    t = tsca.identity_scaling(*[torch.tensor(a) for a in args], pad=pad)
    for name, tv, jv in zip(tsca.ScaledProblem._fields, t, j):
        _close(tv, jv, 0.0, name)


@pytest.mark.parametrize("with_A", [True, False], ids=["with-A", "no-A"])
def test_kkt_solve_cached_matches_jax(with_A):
    """Forward (x, nu), the gradients of Q, A, r and b, and none into the
    factors: the port's factors are built from Q itself (not detached) and
    dQ is still exactly dx x^T."""
    rng = np.random.default_rng(4)
    B, n, m = 3, 10, 2
    Q = _spd(rng, B, n)
    A = rng.standard_normal((B, m, n)) if with_A else None
    b = rng.standard_normal((B, m)) if with_A else None
    r = rng.standard_normal((B, n))
    rho = 0.7
    gx, gnu = rng.standard_normal((B, n)), rng.standard_normal((B, m))

    def jloss(Q, A, r, b):
        f = jlin.factorize_kkt(jax.lax.stop_gradient(Q), rho,
                               None if A is None
                               else jax.lax.stop_gradient(A))
        x, nu = jlin.kkt_solve_cached(f, Q, A, r, b)
        out = jnp.sum(x * gx)
        return out + (0.0 if nu is None else jnp.sum(nu * gnu)), (x, nu)

    jargs = [None if a is None else jnp.asarray(a) for a in (Q, A, r, b)]
    argn = (0, 1, 2, 3) if with_A else (0, 2)
    (_, (jx, jnu)), jg = jax.value_and_grad(jloss, argnums=argn,
                                            has_aux=True)(*jargs)

    tQ, tA, tr, tb = (None if a is None else torch.tensor(
        a, requires_grad=True) for a in (Q, A, r, b))
    f = tlin.factorize_kkt(tQ, rho, tA)
    x, nu = tlin.kkt_solve_cached(f, tQ, tA, tr, tb)
    _close(x, jx, 1e-12, "x")
    loss = (x * torch.tensor(gx)).sum()
    if with_A:
        _close(nu, jnu, 1e-12, "nu")
        loss = loss + (nu * torch.tensor(gnu)).sum()
    else:
        assert nu is None
    tins = [v for v in (tQ, tA, tr, tb) if v is not None]
    tg = torch.autograd.grad(loss, tins)
    for name, t, j in zip(("Q", "A", "r", "b") if with_A else ("Q", "r"),
                          tg, jg):
        _close(t, j, 1e-11, f"d{name}")
    # No gradient reaches Q through the factors: dQ is dx x^T alone.
    dx = tlin.kkt_apply(f, -torch.tensor(gx),
                        None if not with_A else -torch.tensor(gnu))[0]
    assert torch.allclose(tg[0], dx[..., :, None] * x.detach()[..., None, :],
                          rtol=0, atol=1e-14)


def _cfg(**kw):
    base = dict(unroll=True, adaptive_rho=False, eps_abs=1e-8, eps_rel=1e-8)
    base.update(kw)
    return base


def _unrolled_both(data, w, **cfg):
    """x and the gradients of sum(w * x) with respect to all six inputs
    (those given), through boxqp(unroll=True) in both packages."""
    data = _np(data)
    live = [i for i, a in enumerate(data) if a is not None]

    def jl(*args):
        full = list(data)
        for i, a in zip(live, args):
            full[i] = a
        x = J.boxqp(*full, config=J.BoxQPConfig(**cfg))
        return jnp.sum(jnp.asarray(w) * x), x

    (_, jx), jg = jax.value_and_grad(jl, argnums=tuple(range(len(live))),
                                     has_aux=True)(
        *[jnp.asarray(data[i]) for i in live])
    tt = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in data]
    tx = T.boxqp(*tt, config=T.BoxQPConfig(**cfg))
    tg = torch.autograd.grad((torch.tensor(w) * tx).sum(),
                             [tt[i] for i in live])
    return (jx, jg), (tx, tg), [NAMES[i] for i in live]


@pytest.mark.parametrize("case", ["create", "no-equality", "alpha-1",
                                  "cholesky", "3d-layout"])
def test_unrolled_solve_and_gradients_match_jax(case):
    d = list(create_qp_data(8, 2, seed=2, dtype=jnp.float64))
    kw = {}
    if case == "no-equality":
        d[2] = d[3] = None
    elif case == "alpha-1":
        kw = dict(alpha=1.0, unroll_iters=60)
    elif case == "cholesky":
        kw = dict(kkt_solver="cholesky")
    elif case == "3d-layout":
        d = [a if i in (0, 2) else np.asarray(a)[..., None]
             for i, a in enumerate(d)]
    w = np.random.default_rng(5).standard_normal(np.shape(d[1]))
    (jx, jg), (tx, tg), names = _unrolled_both(d, w, **_cfg(**kw))
    assert tuple(tx.shape) == np.shape(jx)
    _close(tx, jx, 1e-10, "x")
    for name, t, j in zip(names, tg, jg):
        assert tuple(t.shape) == np.shape(j), name
        _close(t, j, 1e-9, f"d{name}")


def _count_solves(monkeypatch):
    calls = []
    orig = tlin.kkt_solve_cached

    def spy(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(tlin, "kkt_solve_cached", spy)
    return calls


def test_unrolled_leaves_the_loop_once_done(monkeypatch):
    """Stopping at ``done`` gives what the JAX package's frozen scan gives:
    the same x and gradients with unroll_iters just enough and ten times
    that, and both equal JAX at ten times."""
    calls = _count_solves(monkeypatch)
    d = create_qp_data(8, 2, seed=3, dtype=jnp.float64)
    w = np.random.default_rng(6).standard_normal(np.shape(d.p))
    loose = dict(eps_abs=1e-6, eps_rel=1e-6)
    _, (tx0, tg0), _ = _unrolled_both(d, w, **_cfg(unroll_iters=5000,
                                                   **loose))
    k = len(calls)
    assert 0 < k < 5000
    runs = {}
    for iters in (k, 10 * k):
        calls.clear()
        (jx, jg), (tx, tg), names = _unrolled_both(
            d, w, **_cfg(unroll_iters=iters, **loose))
        assert len(calls) == k, iters
        runs[iters] = (tx, tg)
    for a, b in zip((tx0, *tg0), (runs[k][0], *runs[k][1])):
        assert torch.equal(a, b)
    for a, b in zip((runs[k][0], *runs[k][1]),
                    (runs[10 * k][0], *runs[10 * k][1])):
        assert torch.equal(a, b)
    _close(runs[10 * k][0], jx, 1e-10, "x")
    for name, t, j in zip(names, runs[10 * k][1], jg):
        _close(t, j, 1e-9, f"d{name}")


def test_unrolled_gradients_match_fixed_point():
    """The counterpart of tests/test_box_qp_backward.py's
    test_unrolled_matches_implicit: unrolled to convergence, the gradients
    with respect to Q and p are the implicit fixed-point ones (rtol 5e-3,
    atol 1e-5, as there)."""
    d = create_qp_data(8, 2, seed=2, dtype=jnp.float64)
    w = torch.tensor(np.random.default_rng(3).standard_normal(
        np.shape(d.p)))
    base = dict(eps_abs=1e-8, eps_rel=1e-8, max_iters=20_000)
    grads = []
    for cfg in (T.BoxQPConfig(**base),
                T.BoxQPConfig(unroll=True, unroll_iters=4000,
                              adaptive_rho=False, **base)):
        Q, p, A, b, lb, ub = (torch.tensor(np.asarray(a)) for a in d)
        Q.requires_grad_(True)
        p.requires_grad_(True)
        x = T.boxqp(Q, p, A, b, lb, ub, config=cfg)
        grads.append(torch.autograd.grad((w * x).sum(), (Q, p)))
    for a, b, name in zip(*grads, ("Q", "p")):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-3,
                                   atol=1e-5, err_msg=name)


def test_unrolled_f32_factorizes_through_the_leaf(monkeypatch):
    """In float32 the one factorization goes through the SWEEP leaf (n=200
    pads to 256: two leaves) and the backward through none."""
    leaves = []
    orig = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaves.append(X.shape)
                        or orig(X, **kw))
    d = [torch.tensor(np.asarray(a, np.float32)) for a in
         create_qp_data(200, 2, seed=4, dtype=jnp.float64)]
    d[0].requires_grad_(True)
    x = T.boxqp(*d, config=T.BoxQPConfig(**_cfg(unroll_iters=20)))
    assert leaves == [(2, 128, 128)] * 2
    (gQ,) = torch.autograd.grad(x.sum(), (d[0],))
    assert len(leaves) == 2 and bool(torch.isfinite(gQ).all())


@pytest.mark.parametrize("kw,match", [(dict(polish=True), "polish"),
                                      (dict(acceleration=3), "acceleration")])
def test_unrolled_rejects_polish_and_acceleration(kw, match):
    d = [torch.tensor(np.asarray(a)) for a in
         create_qp_data(6, 2, dtype=jnp.float64)]
    with pytest.raises(ValueError, match=match):
        T.solve_box_qp_unrolled(*d, config=T.BoxQPConfig(**kw))
    with pytest.raises(ValueError, match=match):
        J.solve_box_qp_unrolled(*[jnp.asarray(a.numpy()) for a in d],
                                config=J.BoxQPConfig(**kw))


def test_prep_matches_jax():
    """The unfused preparation: scaled problem, unscaled p-norm and rho
    (auto, with the pad's identity subtracted; fixed; forced to 0 with no
    finite bound)."""
    from lqp_py_tpu.models import box_qp as jbox
    d = _np(create_qp_data(10, 3, seed=7, dtype=jnp.float64))
    for cfg, pad, bounds in ((dict(), 6, True), (dict(rho=0.4), 0, True),
                             (dict(scale=False), 2, True),
                             (dict(), 0, False)):
        dd = list(d) if bounds else d[:4] + [None, None]
        jsp, jpn, jrho, _ = jbox._prep(*[None if a is None else
                                         jnp.asarray(a) for a in dd],
                                       J.BoxQPConfig(**cfg), pad=pad)
        tsp, tpn, trho = tbox._prep(*[None if a is None else torch.tensor(a)
                                      for a in dd], T.BoxQPConfig(**cfg),
                                    pad=pad)
        for name, t, j in zip(tsca.ScaledProblem._fields, tsp, jsp):
            if j is None:
                assert t is None, name
            else:
                _close(t, j, 1e-12, name)
        _close(tpn, jpn, 0.0, "p_norm")
        _close(trho, jrho, 1e-12, f"rho {cfg}")
        assert bounds or bool((trho == 0).all())
