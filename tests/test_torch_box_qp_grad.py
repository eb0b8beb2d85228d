"""Parity of the port's box-QP backward (lqp_py_tpu_torch.models.box_qp_grad
and the ``boxqp`` autograd layer) with the JAX package.

Problems come from the JAX generators or numpy as numpy arrays and go to
both packages.  In float64 both packages solve the backward system by
Cholesky, so they agree to roundoff.  Every gradient check uses a random
weighted loss ``sum(w * x)``: ``create_qp_data`` has a sum-to-one row, so
``sum(x)`` is constant and its p-gradient zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import box_qp_grad as jgrad
from lqp_py_tpu.utils.generators import create_qp_data
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import box_qp_grad as tgrad
from lqp_py_tpu_torch.models import layers as tlayers
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.utils.convert import problem_from_numpy

TIGHT = dict(eps_abs=1e-10, eps_rel=1e-10, max_iters=50000)
NAMES = ("Q", "p", "A", "b", "lb", "ub")


def _data(n, B, seed, case="box"):
    """numpy float64 problem: 'box' (an equality row and finite bounds),
    'no-eq' (A and b None) or 'inf-bounds' (some bounds infinite)."""
    d = [np.asarray(a, np.float64) for a in
         create_qp_data(n, B, seed=seed, dtype=jnp.float64)]
    if case == "no-eq":
        d[2] = d[3] = None
    elif case == "inf-bounds":
        rng = np.random.default_rng(seed)
        d[4] = np.where(rng.random(d[4].shape) < 0.4, -np.inf, d[4])
        d[5] = np.where(rng.random(d[5].shape) < 0.4, np.inf, d[5])
    return d


def _residual_set(d, dtype=torch.float64, **cfg):
    """The layer's saved residual set of a port solve, as numpy."""
    sol = T.solve_box_qp(*problem_from_numpy(*d, device="cpu", dtype=dtype),
                         config=T.BoxQPConfig(**cfg))
    return {k: None if v is None else v.numpy() for k, v in
            dict(x=sol.x, u=sol.u, lams=sol.lams, nus=sol.nus,
                 rho=sol.rho).items()}


def _weights(seed, shape):
    return np.random.default_rng(100 + seed).standard_normal(shape)


def _grad_fn_args(d, res, w, pkg):
    Q, _p, A, _b, lb, ub = d
    n = Q.shape[-1]
    lb = np.full((Q.shape[0], n), -np.inf) if lb is None else lb
    ub = np.full((Q.shape[0], n), np.inf) if ub is None else ub
    conv = (jnp.asarray if pkg is J else torch.tensor)
    c = lambda a: None if a is None else conv(a)  # noqa: E731
    return dict(dl_dz=c(w), x=c(res["x"]), lams=c(res["lams"]),
                nus=c(res["nus"]), Q=c(Q), A=c(A), lb=c(lb), ub=c(ub),
                u=c(res["u"]), rho=c(res["rho"]))


@pytest.mark.parametrize("case", ["box", "no-eq", "inf-bounds"])
@pytest.mark.parametrize("mode", ["fixed_point", "kkt"])
def test_grad_functions_match_jax_on_one_residual_set(mode, case):
    # Both packages take Cholesky in float64: agreement to ~1e-9.
    d = _data(10, 3, seed=1, case=case)
    res = _residual_set(d, **TIGHT)
    w = _weights(1, res["x"].shape)
    targs, jargs = (_grad_fn_args(d, res, w, pkg) for pkg in (T, J))
    if mode == "kkt":
        for a in (targs, jargs):
            del a["u"], a["rho"]
        ours = tgrad.box_qp_grad_kkt(**targs)
        theirs = jgrad.box_qp_grad_kkt(**jargs)
    else:
        ours = tgrad.box_qp_grad_fixed_point(**targs)
        theirs = jgrad.box_qp_grad_fixed_point(**jargs)
    for name, o, t in zip(("dQ", "dp", "dA", "db", "dlb", "dub"), ours,
                          theirs):
        if t is None:
            assert o is None, name
            continue
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    assert np.abs(ours[1].numpy()).max() > 1e-3      # a non-trivial dp


def test_kkt_jacobian_helpers_match_jax_and_the_condensed_solve():
    """make_kkt_jacobian + solve_kkt_backwards + qp_int_grads (the
    uncondensed KKT path, box as G = [-I; I]) against the JAX helpers, and
    their dp against box_qp_grad_kkt's condensed solve."""
    d = _data(8, 2, seed=7)
    Q, _p, A, _b, lb, ub = d
    res = _residual_set(d, **TIGHT)
    w = _weights(7, res["x"].shape)
    n = Q.shape[-1]
    G = np.concatenate([-np.eye(n), np.eye(n)])[None].repeat(2, axis=0)
    x, lams, nus = res["x"], np.maximum(res["lams"], 1e-8), res["nus"]
    slacks = np.clip(np.concatenate([x - lb, ub - x], axis=-1), 1e-8, 1e12)
    args = (Q, G, A, lams, slacks)
    ours = tgrad.make_kkt_jacobian(*map(torch.from_numpy, args))
    theirs = jgrad.make_kkt_jacobian(*map(jnp.asarray, args))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    dx, dlam, dnu = tgrad.solve_kkt_backwards(torch.from_numpy(w), ours,
                                              A.shape[-2], 2 * n)
    jdx, jdlam, jdnu = jgrad.solve_kkt_backwards(jnp.asarray(w), theirs,
                                                 A.shape[-2], 2 * n)
    for o, t in ((dx, jdx), (dlam, jdlam), (dnu, jdnu)):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-9,
                                   atol=1e-10)
    ints = tgrad.qp_int_grads(*(torch.from_numpy(a) for a in (x, lams, nus)),
                              dx, dlam, dnu)
    jints = jgrad.qp_int_grads(*(jnp.asarray(a) for a in (x, lams, nus)),
                               jdx, jdlam, jdnu)
    for o, t in zip(ints, jints):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-9,
                                   atol=1e-10)
    condensed = tgrad.box_qp_grad_kkt(**{
        k: v for k, v in _grad_fn_args(d, res, w, T).items()
        if k not in ("u", "rho")})
    np.testing.assert_allclose(ints[1].numpy(), condensed[1].numpy(),
                               rtol=1e-7, atol=1e-9)


def _port_grads(d, w, **cfg):
    ts = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in d]
    x = T.boxqp(*ts, config=T.BoxQPConfig(**cfg))
    loss = (torch.from_numpy(w) * x).sum()
    grads = torch.autograd.grad(loss, [t for t in ts if t is not None])
    return x, list(grads)


@pytest.mark.parametrize("mode", ["fixed_point", "kkt"])
def test_layer_grads_match_jax_grad(mode):
    """jax.grad and torch.autograd.grad of sum(w * x) with respect to all
    six inputs, float64, solve tolerance 1e-10: agreement to ~1e-9."""
    d = _data(12, 3, seed=4)
    w = _weights(4, d[1].shape)
    cfg = dict(TIGHT, backward=mode)

    def loss(*args):
        x = J.boxqp(*args, config=J.BoxQPConfig(**cfg))
        return jnp.sum(jnp.asarray(w) * x)

    theirs = jax.grad(loss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in d])
    _, ours = _port_grads(d, w, **cfg)
    for name, o, t in zip(NAMES, ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_layer_grads_match_finite_differences():
    """Directional central differences of the port's own solve, for each
    input, against both backward modes; the tolerance of
    tests/test_box_qp_backward.py (rtol 2e-3, atol 5e-5)."""
    d = _data(6, 2, seed=0)
    w = _weights(0, d[1].shape)
    rng = np.random.default_rng(5)

    def f(args):
        x = T.solve_box_qp(*problem_from_numpy(*args, device="cpu"),
                           config=T.BoxQPConfig(**TIGHT)).x
        return float((torch.from_numpy(w) * x).sum())

    eps = 1e-6
    fd = []
    dirs = []
    for i, a in enumerate(d):
        v = rng.standard_normal(a.shape)
        if i == 0:
            v = v + np.swapaxes(v, -1, -2)       # keep Q symmetric
        plus, minus = list(d), list(d)
        plus[i], minus[i] = a + eps * v, a - eps * v
        fd.append((f(plus) - f(minus)) / (2 * eps))
        dirs.append(v)
    for mode in ("fixed_point", "kkt"):
        _, grads = _port_grads(d, w, **TIGHT, backward=mode)
        for name, g, v, ref in zip(NAMES, grads, dirs, fd):
            got = float((g.numpy() * v).sum())
            np.testing.assert_allclose(got, ref, rtol=2e-3, atol=5e-5,
                                       err_msg=f"{name} ({mode})")


def test_f32_fixed_point_backward_on_recursion_matches_f64(monkeypatch):
    """float32 at n=200: the masked system is padded to 256 and solved by
    the Schur recursion with the plain SWEEP leaf (two 128 leaves), fed
    the same residual set as the float64 (Cholesky) backward.  Bound:
    relative max difference of dp and dQ <= 1e-5 (float32 roundoff through
    a Jacobi-equilibrated system of condition ~40; 5e-7 measured)."""
    leaf_calls = []
    orig = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaf_calls.append(tuple(X.shape))
                        or orig(X, **kw))
    d = _data(200, 4, seed=6)
    res = _residual_set(d, dtype=torch.float32, eps_abs=1e-5, eps_rel=1e-5)
    w = _weights(6, res["x"].shape)
    out = {}
    leaf_calls.clear()
    for dtype in (np.float32, np.float64):
        args = _grad_fn_args(
            [None if a is None else a.astype(dtype) for a in d],
            {k: None if v is None else v.astype(dtype)
             for k, v in res.items()}, w.astype(dtype), T)
        out[dtype] = tgrad.box_qp_grad_fixed_point(**args)
        if dtype == np.float32:
            assert leaf_calls == [(4, 128, 128)] * 2
            assert out[dtype][1].dtype == torch.float32
    for i in (0, 1):
        a, b = out[np.float32][i].double(), out[np.float64][i]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel <= 1e-5, (i, rel)


def test_none_inputs_and_column_layout():
    """A, b, lb and ub passed as None get no gradient; (B, n, 1) inputs
    give a (B, n, 1) output and (B, n, 1) gradients equal to the (B, n)
    layout's."""
    d = _data(8, 2, seed=2)
    w = _weights(2, d[1].shape)
    Q = torch.tensor(d[0], requires_grad=True)
    p2 = torch.tensor(d[1], requires_grad=True)
    p3 = torch.tensor(d[1][..., None], requires_grad=True)
    cfg = T.BoxQPConfig(**TIGHT)
    x2 = T.boxqp(Q, p2, config=cfg)
    x3 = T.boxqp(Q, p3, config=cfg)
    assert tuple(x3.shape) == (2, 8, 1)
    torch.testing.assert_close(x3[..., 0], x2, rtol=0, atol=0)
    g2 = torch.autograd.grad((torch.from_numpy(w) * x2).sum(), (Q, p2))
    g3 = torch.autograd.grad((torch.from_numpy(w)[..., None] * x3).sum(),
                             (Q, p3))
    assert tuple(g3[1].shape) == (2, 8, 1)
    torch.testing.assert_close(g3[1][..., 0], g2[1], rtol=0, atol=0)
    torch.testing.assert_close(g3[0], g2[0], rtol=0, atol=0)

    res = _residual_set((d[0], d[1], None, None, None, None), **TIGHT)
    assert res["nus"] is None
    x, u, lams, rho = (torch.from_numpy(res[k])
                       for k in ("x", "u", "lams", "rho"))
    out = tlayers._boxqp_bwd(cfg, (x, u, lams, None, Q.detach(), None, None,
                                   None, rho, (True, True)),
                             torch.from_numpy(w))
    assert out[0] is not None and out[1] is not None
    assert out[2:] == (None, None, None, None)


@pytest.mark.parametrize("mode", ["fixed_point", "kkt"])
def test_unwanted_outer_products_are_not_built(mode, monkeypatch):
    """Q and A not requiring grad: the backward is asked for neither dQ nor
    dA and builds neither."""
    seen = []
    name = "box_qp_grad_kkt" if mode == "kkt" else "box_qp_grad_fixed_point"
    orig = getattr(tgrad, name)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        seen.append((kw["want_dQ"], kw["want_dA"], out[0], out[2]))
        return out

    monkeypatch.setattr(tgrad, name, spy)
    d = _data(8, 2, seed=3)
    Q, p, A, b, lb, ub = (torch.tensor(a) for a in d)
    p.requires_grad_(True)
    x = T.boxqp(Q, p, A, b, lb, ub, config=T.BoxQPConfig(**TIGHT,
                                                         backward=mode))
    (gp,) = torch.autograd.grad(x.sum() + (x * x).sum(), (p,))
    assert seen == [(False, False, None, None)]
    assert torch.isfinite(gp).all()


def test_unroll_and_unknown_backward_raise():
    d = problem_from_numpy(*_data(6, 2, seed=0), device="cpu")
    p = d.p.clone().requires_grad_(True)
    x = T.boxqp(d.Q, p, d.A, d.b, d.lb, d.ub,
                config=T.BoxQPConfig(backward="nope"))
    with pytest.raises(ValueError, match="unknown backward mode"):
        x.sum().backward()
