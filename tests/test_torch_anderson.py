"""Parity of the port's Anderson acceleration with the JAX package:
``aa_step`` step by step (ring slots, the safeguard reset, ``hold``, the
``max_weight`` reject, ``aa_reset_where``) and ``solve_box_qp`` with
``acceleration=m`` (equal iterations, x within 1e-8), including a hard set
on which adaptive rho resets the history and the final clip of z.

float64 on numpy-seeded data.  The ring buffers match to 1e-12.  The
combination solves the Gram system regularized at 1e-8 relative: when
history columns are nearly collinear (right after a reset) it amplifies
rounding differences of the two packages' summation orders by up to 1e8,
so the accelerated iterate is held to 1e-7, and the solve's fields other
than x to 1e-7 absolute and relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.ops import anderson as janderson
from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.ops import anderson as tanderson
from lqp_py_tpu_torch.utils.convert import problem_from_numpy
from lqp_py_tpu_torch.utils.generators import kkt_residuals

FIELDS = ("x", "z", "u", "lams", "nus", "rho")


def _close(t, j, atol, what="", rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


def _state_close(ts, js, what):
    for name in ("Gh", "Rh", "rn"):
        _close(getattr(ts, name), getattr(js, name), 1e-12, f"{what} {name}")


def test_aa_step_sequence_matches_jax():
    """A contraction map iterated through aa_step in both packages: ten
    steps on a ring of 3 (the slot wraps), a kick that trips the
    safeguard reset, a held element, a max_weight that rejects, and a
    forced reset by aa_reset_where."""
    rng = np.random.default_rng(0)
    B, m, d = 4, 3, 6
    M = 0.5 * rng.standard_normal((B, d, d)) / np.sqrt(d)
    c = rng.standard_normal((B, d))

    def g(v):
        return np.einsum("bij,bj->bi", M, v) + c

    js = janderson.aa_init(B, m, d, jnp.float64)
    ts = tanderson.aa_init(B, m, d, torch.float64)
    _state_close(ts, js, "init")
    v = rng.standard_normal((B, d))
    hold = np.array([False, False, True, False])
    accepted = []
    for it in range(14):
        kw = dict(safeguard=2.0, reg=1e-8,
                  max_weight=1e-3 if it == 9 else 1e3)
        if it == 6:
            v = v + 50.0 * rng.standard_normal((B, d))   # trips the reset
        if it == 11:
            mask = np.array([True, False, False, True])
            js = janderson.aa_reset_where(js, jnp.asarray(mask))
            ts = tanderson.aa_reset_where(ts, torch.tensor(mask))
            _state_close(ts, js, "reset_where")
        gv = g(v)
        jv, js = janderson.aa_step(js, jnp.asarray(v), jnp.asarray(gv),
                                   jnp.int32(it % m), jnp.asarray(hold), **kw)
        tv, ts = tanderson.aa_step(ts, torch.tensor(v), torch.tensor(gv),
                                   it % m, torch.tensor(hold), **kw)
        _close(tv, jv, 1e-7, f"v_next at step {it}")
        _state_close(ts, js, f"step {it}")
        accepted.append((tv.numpy() != gv).any(axis=-1))
        v = tv.numpy()
    acc = np.array(accepted)
    assert not acc[:, 2].any()                 # held: always the plain step
    assert acc[3:6, [0, 1, 3]].all()           # accelerated once warm
    assert not acc[6].any() and not acc[9].any()   # reset, rejected
    assert not acc[11, [0, 3]].any()           # forced reset


def _both(data, **cfg):
    d = [None if a is None else np.asarray(a, np.float64) for a in data]
    js = J.solve_box_qp(*[None if a is None else jnp.asarray(a) for a in d],
                        config=J.BoxQPConfig(**cfg))
    ts = T.solve_box_qp(*problem_from_numpy(*d, device="cpu"),
                        config=T.BoxQPConfig(**cfg))
    return js, ts, d


def _assert_same_solve(js, ts):
    assert ts.iterations == int(js.iterations)
    for f in FIELDS:
        a, b = getattr(js, f), getattr(ts, f)
        if a is None:
            assert b is None, f
        else:
            _close(b, a, 1e-8 if f == "x" else 1e-7, f,
                   rtol=0.0 if f == "x" else 1e-7)
    np.testing.assert_array_equal(ts.converged.numpy(),
                                  np.asarray(js.converged))


@pytest.mark.parametrize("case,m", [("create", 5), ("hard", 10)])
def test_accelerated_solve_matches_jax(case, m):
    data = (create_qp_data(30, 4, seed=1, dtype=jnp.float64)
            if case == "create" else generate_hard_qp(50, 4, seed=0))
    cfg = dict(eps_abs=1e-5, eps_rel=1e-5, acceleration=m)
    js, ts, d = _both(data, **cfg)
    _assert_same_solve(js, ts)
    assert bool(ts.converged.all())
    if case == "hard":
        # Fewer iterations than plain, and a KKT point of the same quality
        # (gated on kkt_residuals, not on the distance to the plain x).
        plain = T.solve_box_qp(*problem_from_numpy(*d, device="cpu"),
                               config=T.BoxQPConfig(eps_abs=1e-5,
                                                    eps_rel=1e-5))
        assert ts.iterations < plain.iterations
        tdat = problem_from_numpy(*d, device="cpu")
        r_aa = kkt_residuals(*tdat, ts.x, ts.lams, ts.nus)
        r_pl = kkt_residuals(*tdat, plain.x, plain.lams, plain.nus)
        for name in r_aa:
            assert r_aa[name].max() <= 10 * r_pl[name].max() + 1e-6, name


def test_rho_update_resets_the_history_like_jax(monkeypatch):
    """On a hard set adaptive rho fires during an accelerated solve: the
    updated elements' history is reset and the solve still matches JAX."""
    resets = []
    orig = tanderson.aa_reset_where

    def spy(state, mask):
        resets.append(mask.clone())
        return orig(state, mask)

    monkeypatch.setattr(tanderson, "aa_reset_where", spy)
    cfg = dict(eps_abs=1e-6, eps_rel=1e-6, acceleration=4)
    js, ts, _ = _both(generate_hard_qp(30, 4), **cfg)
    _assert_same_solve(js, ts)
    assert resets and any(bool(r.any()) for r in resets)


def test_final_z_is_clipped_into_the_box():
    """The returned z of an accelerated solve lies in the box (up to the
    unscaling's rounding), as the JAX package's does."""
    js, ts, d = _both(generate_hard_qp(50, 4, seed=1),
                      eps_abs=1e-4, eps_rel=1e-4, acceleration=10)
    _close(ts.z, js.z, 1e-8, "z")
    lb, ub = torch.tensor(d[4]), torch.tensor(d[5])
    viol = torch.clamp(torch.maximum(lb - ts.z, ts.z - ub), min=0.0)
    assert float(viol.max()) <= 8 * torch.finfo(torch.float64).eps
