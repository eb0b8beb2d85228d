"""Parity of the port's problem scaling (lqp_py_tpu_torch.ops.scaling and
the solver's ``_prep_h``) with the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqp_py_tpu import BoxQPConfig as JaxConfig
from lqp_py_tpu.models import box_qp as jbox
from lqp_py_tpu.ops import scaling as jsca
from lqp_py_tpu_torch import BoxQPConfig
from lqp_py_tpu_torch.models import box_qp as tbox
from lqp_py_tpu_torch.ops import scaling as tsca


def _problem(seed, B=4, n=50, m=2, zero_col=False):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L, L) / (2 * n)
    Q *= rng.uniform(0.1, 10.0, (B, 1, n))      # uneven column scales
    Q = 0.5 * (Q + np.swapaxes(Q, -1, -2))
    if zero_col:
        Q[0, :, 3] = 0.0
        Q[0, 3, :] = 0.0
    p = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    b = rng.standard_normal((B, m))
    lb = -rng.uniform(1.0, 2.0, (B, n))
    ub = rng.uniform(1.0, 2.0, (B, n))
    lb[:, :5] = -np.inf                          # some one-sided bounds
    ub[1, 7] = np.inf
    return Q, p, A, b, lb, ub


def _assert_close(ours, theirs, dtype, name):
    ours = ours.numpy()
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, name
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(theirs),
                                  err_msg=name)
    fin = np.isfinite(theirs)
    np.testing.assert_array_equal(ours[~fin], theirs[~fin], err_msg=name)
    err = np.max(np.abs(ours[fin] - theirs[fin]), initial=0.0)
    scale = np.max(np.abs(theirs[fin]), initial=1.0)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol} * {scale:.3e}"


CASES = [
    pytest.param(np.float64, {}, False, id="f64-auto"),
    pytest.param(np.float64, {"beta": 0.3, "rho": 0.7}, False,
                 id="f64-fixed-beta-rho"),
    pytest.param(np.float64, {"scale": False}, False, id="f64-unscaled"),
    pytest.param(np.float64, {}, True, id="f64-zero-column"),
    pytest.param(np.float32, {}, False, id="f32-auto"),
    pytest.param(np.float32, {"symmetrize": False}, False,
                 id="f32-no-symmetrize"),
]


@pytest.mark.parametrize("dtype,cfg,zero_col", CASES)
def test_prep_h_matches_jax(dtype, cfg, zero_col):
    data = [a.astype(dtype) for a in _problem(0, zero_col=zero_col)]
    pad = 128 - 50
    sph_t, pn_t, rho_t = tbox._prep_h(*map(torch.from_numpy, data),
                                      BoxQPConfig(**cfg), pad=pad)
    sph_j, pn_j, rho_j, _ = jbox._prep_h(*map(jnp.asarray, data),
                                         JaxConfig(**cfg), pad=pad)
    for name in ("H", "p", "A", "b", "lb", "ub", "D", "E"):
        _assert_close(getattr(sph_t, name), getattr(sph_j, name), dtype,
                      name)
    _assert_close(rho_t, rho_j, dtype, "rho")
    _assert_close(pn_t, pn_j, dtype, "p_norm")
    assert sph_t.H.dtype == torch.from_numpy(data[0]).dtype


def test_scaled_frobenius_norm_matches_jax():
    # The auto-rho reads ||D Q D||_F through the quadratic form; hand the
    # raw value out through the rho callable and compare it.
    data = _problem(1)
    got_t, got_j = [], []
    tsca.scale_problem_h(*map(torch.from_numpy, data),
                         lambda D, q: got_t.append(q) or q)
    jsca.scale_problem_h(*map(jnp.asarray, data),
                         lambda D, q: got_j.append(q) or q)
    _assert_close(got_t[0], got_j[0], np.float64, "q_fro")
    # And it is the Frobenius norm of the scaled Q.
    sph, _ = tsca.scale_problem_h(*map(torch.from_numpy, data),
                                  lambda D, q: torch.zeros_like(q))
    fro = torch.linalg.matrix_norm(sph.H, ord="fro")
    np.testing.assert_allclose(got_t[0].numpy(), fro.numpy(), rtol=1e-12)


def test_no_finite_bound_forces_rho_zero():
    Q, p, A, b, _, _ = _problem(2)
    _, _, rho = tbox._prep_h(*map(torch.from_numpy, (Q, p, A, b)), None,
                             None, BoxQPConfig())
    assert torch.all(rho == 0)
