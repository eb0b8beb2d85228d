"""Parity of the port's early-exit ADMM step (lqp_py_tpu_torch.ops.kernels
.admm_step, ``use_pallas_step=True``) with the JAX package.

Inputs are made with numpy (or the JAX generators) and handed to both
packages.  The JAX early-exit GEMV runs in Pallas interpret mode on the CPU,
as tests/test_pallas_step.py runs it; the port runs the kernel's plain
version there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.ops import linalg as jlin
from lqp_py_tpu.ops.pallas import admm_step as jstep
from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.ops.kernels import admm_step as tstep
from lqp_py_tpu_torch.utils.convert import problem_from_numpy

MASK = np.array([False, True, False, True])


def _np(data):
    return tuple(None if a is None else np.asarray(a) for a in data)


def _jax(data):
    return [None if a is None else jnp.asarray(a) for a in data]


def _close(ours, theirs, rtol):
    """Entrywise agreement scaled by the largest entry (an entrywise rtol
    would fail on entries near zero)."""
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, rtol=rtol,
                               atol=rtol * np.abs(theirs).max())


def _gemv_inputs(dtype, B=4, n=256, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((B, n, n)).astype(dtype)
    r = rng.standard_normal((B, n)).astype(dtype)
    x_prev = rng.standard_normal((B, n)).astype(dtype)
    return P, r, x_prev


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_gemv_plain_version_matches_jax(dtype, rtol):
    P, r, x_prev = _gemv_inputs(dtype)
    ours = tstep.gemv_early_exit_ref(*map(torch.from_numpy, (P, r, x_prev)),
                                     torch.from_numpy(MASK)).numpy()
    theirs = np.asarray(jstep.gemv_early_exit(
        jnp.asarray(P), jnp.asarray(r), jnp.asarray(x_prev),
        jnp.asarray(MASK)))
    # Frozen rows are x_prev bitwise, on both sides.
    np.testing.assert_array_equal(ours[MASK], x_prev[MASK])
    np.testing.assert_array_equal(theirs[MASK], x_prev[MASK])
    _close(ours[~MASK], theirs[~MASK], rtol)


@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_fused_step_matches_jax(alpha):
    B, n = 4, 256
    P, r, x = _gemv_inputs(np.float64, B, n, seed=1)
    rng = np.random.default_rng(2)
    z, u, p, q = (rng.standard_normal((B, n)) for _ in range(4))
    lb = -rng.uniform(0.5, 1.5, (B, n))
    ub = rng.uniform(0.5, 1.5, (B, n))
    rho = rng.uniform(0.1, 2.0, B)
    args = (P, r, x, z, u, p, q, lb, ub, rho, MASK)
    ours = tstep.fused_admm_step(*map(torch.from_numpy, args), alpha=alpha)
    theirs = jstep.fused_admm_step(*map(jnp.asarray, args), alpha=alpha)
    for name, o, t, prev in zip("xzur", ours, theirs, (x, z, u, r)):
        np.testing.assert_array_equal(o.numpy()[MASK], prev[MASK],
                                      err_msg=name)
        _close(o.numpy(), t, 1e-12)


@pytest.mark.parametrize("with_eq", [True, False], ids=["with-A", "no-A"])
def test_materialized_p_matches_jax(with_eq):
    B, n, m = 2, 200, 14
    rng = np.random.default_rng(3)
    L = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L, L) / (2 * n)
    A = rng.standard_normal((B, m, n)) if with_eq else None
    rho = np.array([0.3, 1.7])
    t = None if A is None else torch.from_numpy(A)
    f_t = tlin.factorize_kkt(torch.from_numpy(Q), torch.from_numpy(rho), t,
                             materialize_p=True)
    f_j = jlin.factorize_kkt(jnp.asarray(Q), jnp.asarray(rho),
                             None if A is None else jnp.asarray(A),
                             mode="inverse", materialize_p=True)
    np.testing.assert_allclose(f_t.P.numpy(), np.asarray(f_j.P), rtol=0,
                               atol=1e-10)
    if with_eq:
        assert torch.allclose(f_t.P, f_t.Hinv - f_t.WS @ f_t.W.mT,
                              rtol=0, atol=1e-14)
    else:
        assert f_t.P is f_t.Hinv
    assert tlin.factorize_kkt(torch.from_numpy(Q), torch.from_numpy(rho),
                              t).P is None


# The three cases of tests/test_pallas_step.py.
CASES = {
    "alpha1": (dict(n=50, B=4, seed=0, eq=True),
               dict(eps_abs=1e-7, eps_rel=1e-7, alpha=1.0)),
    "relaxed": (dict(n=50, B=4, seed=0, eq=True),
                dict(eps_abs=1e-7, eps_rel=1e-7, alpha=1.6)),
    "no-eq-n128": (dict(n=128, B=2, seed=1, eq=False),
                   dict(eps_abs=1e-7, eps_rel=1e-7)),
}


@functools.cache
def _case_data(name):
    d, _ = CASES[name]
    Q, p, A, b, lb, ub = _np(create_qp_data(d["n"], d["B"], seed=d["seed"],
                                            dtype=jnp.float64))
    return (Q, p, A, b, lb, ub) if d["eq"] else (Q, p, None, None, lb, ub)


def _port(data, **cfg):
    return T.solve_box_qp(*problem_from_numpy(*data, device="cpu"),
                          config=T.BoxQPConfig(**cfg))


@pytest.mark.parametrize("name", list(CASES))
def test_early_exit_matches_lock_step(name):
    data, cfg = _case_data(name), CASES[name][1]
    lock = _port(data, **cfg)
    early = _port(data, use_pallas_step=True, **cfg)
    assert bool(early.converged.all())
    x, x_ref = early.x.numpy(), lock.x.numpy()
    if name == "alpha1":
        # alpha = 1 pins the plain iteration: step for step the same.
        assert early.iterations == lock.iterations
        np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(early.nus.numpy(), lock.nus.numpy(),
                                   rtol=1e-9, atol=1e-12)
    elif name == "relaxed":
        # Relaxed: converged elements freeze at slightly other iterates.
        np.testing.assert_allclose(x, x_ref, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(x, x_ref, rtol=1e-4, atol=1e-6)


def _assert_same_early_exit(ours, theirs, tol=1e-8):
    assert ours.iterations == int(theirs.iterations)
    np.testing.assert_array_equal(ours.converged.numpy(),
                                  np.asarray(theirs.converged))
    for f in ("x", "rho"):
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   np.asarray(getattr(theirs, f)), rtol=0,
                                   atol=tol, err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_early_exit_matches_jax(name):
    data, cfg = _case_data(name), CASES[name][1]
    theirs = J.solve_box_qp(*_jax(data),
                            config=J.BoxQPConfig(use_pallas_step=True, **cfg))
    ours = _port(data, use_pallas_step=True, **cfg)
    _assert_same_early_exit(ours, theirs)


def _straggler_batch(n_x=64, n_batch=8, n_hard=2):
    """experiments/experiment_straggler.py's batch: hard problems, all but
    ``n_hard`` of them ridged with mean(diag Q) * I into easy ones."""
    Q, p, A, b, lb, ub = _np(generate_hard_qp(n_x, n_batch))
    ridge = np.diagonal(Q, axis1=-2, axis2=-1).mean(axis=-1)
    easy = np.arange(n_batch) < n_batch - n_hard
    Q = Q + np.where(easy, ridge, 0.0)[:, None, None] * np.eye(n_x)
    return Q, p, A, b, lb, ub


@pytest.mark.parametrize("max_iters", [4000, 100], ids=["full", "capped"])
def test_straggler_batch_matches_jax(max_iters):
    data = _straggler_batch()
    cfg = dict(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False,
               max_iters=max_iters, use_pallas_step=True)
    theirs = J.solve_box_qp(*_jax(data), config=J.BoxQPConfig(**cfg))
    ours = _port(data, **cfg)
    _assert_same_early_exit(ours, theirs)
    n_conv = int(ours.converged.sum())
    if max_iters == 4000:
        assert n_conv == 8 and ours.iterations > 300
    else:
        # Stopped mid-solve: some elements frozen, some still running.
        assert ours.iterations == 100 and 0 < n_conv < 8


def test_gemv_wrapper_takes_plain_version_on_cpu():
    P, r, x_prev = map(torch.from_numpy, _gemv_inputs(np.float32, n=40))
    conv = torch.from_numpy(MASK)
    before = tstep.LAUNCHES
    out = tstep.gemv_early_exit(P, r, x_prev, conv)
    assert tstep.LAUNCHES == before
    assert torch.equal(out, tstep.gemv_early_exit_ref(P, r, x_prev, conv))
    with pytest.raises(ValueError, match="unsupported device"):
        tstep.gemv_early_exit(P.to("meta"), r.to("meta"), x_prev.to("meta"),
                              conv.to("meta"))
