"""Parity of the port's general-inequality splitting solver with the JAX
package: ``solve_qp_gen`` on the box written as G, with and without
equality rows, on general inequalities, through adaptive-rho
refactorizations under both update policies, with Anderson acceleration
and with the polish; warm starts, the prepared solve fed the JAX package's
own preparation, the stateful ``GenQP``, an infeasible element, and one
float32 case.

float64 on numpy-seeded data at eps_abs = eps_rel = 1e-9.  Both packages
factor float64 by Cholesky, so the iteration counts, converged masks and
``primal_infeasible`` masks are equal, x and nus match to 1e-8, and lams
and slacks to 1e-6 relative to each element's largest entry.  float32 takes
another route on the CPU in each package (the recursion with the plain leaf
against Cholesky; ROADMAP Queue 3), so that case is held to 2e-3.  The JAX
solves are computed once per module.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import genqp as jgen
from lqp_py_tpu.utils.generators import create_qp_data
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.ops.operator import DENSE
from lqp_py_tpu_torch.utils.convert import (gen_prepared_from_numpy,
                                            gen_problem_from_numpy,
                                            qp_solution_from_numpy)

BASE = dict(eps_abs=1e-9, eps_rel=1e-9)
# (data, equality rows, config).  The box and general data converge before
# the first adaptive-rho window (it >= 100); rho_scale 0.003 (0.01 with
# Anderson) puts rho far enough from balance that the window refactorizes.
# With Anderson at rho_scale 0.003 the two packages' rounding differences
# grow to 6e-7 in x by iteration 26 (the Anderson least squares amplifies
# them) and the counts part: not a parity case.  On the 'mixed' batch (one
# element's Q 100x the others', unscaled, rho 1) the two rho policies take
# different iteration counts (151 and 301).
CASES = {
    "box": ("box", True, dict()),
    "box-no-A": ("box", False, dict()),
    "general": ("general", True, dict()),
    "general-no-A": ("general", False, dict()),
    "box-rho-updates": ("box", True, dict(rho_scale=0.003)),
    "mixed-rescale-all": ("mixed", False, dict(rho=1.0, scale=False)),
    "mixed-per-element": ("mixed", False, dict(
        rho=1.0, scale=False, adaptive_rho_per_element=True)),
    "box-anderson": ("box", True, dict(acceleration=5)),
    "box-anderson-rho-updates": ("box", True, dict(acceleration=5,
                                                   rho_scale=0.01)),
    "box-polish": ("box", True, dict(polish=True)),
    "general-polish": ("general", True, dict(polish=True)),
    "infeasible": ("infeasible", True, dict()),
}
FIELDS = ("x", "lams", "slacks", "nus", "iterations", "primal_residual",
          "dual_residual", "converged", "primal_infeasible")


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _box():
    d = create_qp_data(30, 4, seed=0, dtype=jnp.float64)
    G, h = d.with_G_h()
    return [np.array(a, np.float64) for a in (d.Q, d.p, d.A, d.b, G, h)]


def _general(scale_q1=1.0):
    """Random inequalities around a strictly feasible point
    (tests/test_optnet.py's construction, from numpy)."""
    rng = np.random.default_rng(2)
    B, n, ni, m = 3, 12, 8, 2
    L = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.1 * np.eye(n)
    Q[1] *= scale_q1
    p = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    x0 = rng.standard_normal((B, n))
    G = rng.standard_normal((B, ni, n))
    h = np.einsum("bki,bi->bk", G, x0) + rng.uniform(0.5, 1.5, (B, ni))
    return [Q, p, A, np.einsum("bmi,bi->bm", A, x0), G, h]


def _infeasible():
    """sum(x) = b with x <= 1, n = 5: feasible for b = 2, infeasible for
    b = 10 (tests/test_infeasibility.py's construction)."""
    rng = np.random.default_rng(9)
    B, n = 2, 5
    L = rng.standard_normal((B, 2 * n, n))
    Q = np.einsum("bsi,bsj->bij", L, L) / (2 * n) + 0.5 * np.eye(n)
    return [Q, rng.standard_normal((B, n)), np.ones((B, 1, n)),
            np.array([[2.0], [10.0]]), np.broadcast_to(np.eye(n), (B, n, n)),
            np.ones((B, n))]


def _problem(data, with_A):
    d = {"box": _box, "general": _general, "infeasible": _infeasible,
         "mixed": lambda: _general(scale_q1=100.0)}[data]()
    if not with_A:
        d[2] = d[3] = None
    return d


def _cfg(pkg, **kw):
    return pkg.GenQPConfig(**{**BASE, **kw})


@pytest.fixture(scope="module")
def jax_solves():
    """Each case's data and the JAX package's solution."""
    out = {}
    for case, (data, with_A, kw) in CASES.items():
        d = _problem(data, with_A)
        out[case] = (d, jgen.solve_qp_gen(*_jax(d), config=_cfg(J, **kw)))
    return out


def _close(t, j, what, atol=1e-8):
    if j is None:
        assert t is None, what
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0.0,
                               atol=atol, err_msg=what)


def _close_rel(t, j, what, rtol=1e-6):
    """Within ``rtol`` of each element's largest entry."""
    j = np.asarray(j)
    scale = np.abs(j).max(axis=-1, keepdims=True)
    err = np.abs(t.numpy() - j)
    assert (err <= rtol * scale).all(), (what, (err / scale).max())


def _assert_matches(t, j, residual_tol=1e-9):
    assert t.iterations == int(j.iterations)
    for f in ("converged", "primal_infeasible"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("x", "nus"):
        _close(getattr(t, f), getattr(j, f), f)
    for f in ("lams", "slacks"):
        _close_rel(getattr(t, f), getattr(j, f), f)
    # The last residuals sit below the stopping tolerance, at rounding
    # level: held to the tolerance.
    for f in ("primal_residual", "dual_residual"):
        _close(getattr(t, f), getattr(j, f), f, atol=residual_tol)


@pytest.mark.parametrize("case", list(CASES))
def test_solve_qp_gen_matches_jax(jax_solves, case):
    d, j = jax_solves[case]
    # The solver factors through its operator (``ops/operator.py``).
    calls = []
    factorize = DENSE.factorize

    def counted(*args, **kw):
        calls.append(1)
        return factorize(*args, **kw)

    DENSE.factorize = counted
    try:
        t = T.solve_qp_gen(*gen_problem_from_numpy(*d, device="cpu"),
                           config=_cfg(T, **CASES[case][2]))
    finally:
        del DENSE.factorize                     # the class's method again
    _assert_matches(t, j)
    if case == "infeasible":
        assert t.primal_infeasible.tolist() == [False, True]
        assert t.converged.tolist() == [True, False]
    else:
        assert bool(t.converged.all())
    # The refactorizations the cases were built for did happen.
    assert (len(calls) > 1) == ("rho-updates" in case or "mixed" in case)


def test_warm_start_from_the_jax_solution_matches_jax(jax_solves):
    """Both packages re-solve a drifted p from the JAX solution."""
    d, j = jax_solves["box"]
    p2 = d[1] + 0.005 * np.random.default_rng(13).standard_normal(
        d[1].shape)
    d2 = [d[0], p2, *d[2:]]
    # A check every 5 iterations, so that the count resolves the warm
    # start's gain.
    jw = jgen.solve_qp_gen(*_jax(d2), config=_cfg(J, check_solved=5),
                           warm_start=j)
    ws = qp_solution_from_numpy({f: None if getattr(j, f) is None
                                 else np.asarray(getattr(j, f))
                                 for f in FIELDS}, device="cpu")
    tw = T.solve_qp_gen(*gen_problem_from_numpy(*d2, device="cpu"),
                        config=_cfg(T, check_solved=5), warm_start=ws)
    _assert_matches(tw, jw)
    cold = T.solve_qp_gen(*gen_problem_from_numpy(*d2, device="cpu"),
                          config=_cfg(T, check_solved=5))
    assert tw.iterations < cold.iterations


def _gen_prepared_fields(jprep):
    """A JAX GenQPPrepared as the mapping ``gen_prepared_from_numpy``
    takes."""
    out = {f.name: None if getattr(jprep, f.name) is None
           else np.asarray(getattr(jprep, f.name))
           for f in dataclasses.fields(jprep)
           if f.name not in ("factors", "key")}
    out["factors"] = {f.name: None if getattr(jprep.factors, f.name) is None
                      else np.asarray(getattr(jprep.factors, f.name))
                      for f in dataclasses.fields(jprep.factors)}
    out["key"] = jprep.key
    return out


def test_prepared_solve_on_the_jax_preparation_matches_jax(jax_solves):
    """``solve_qp_gen_prepared`` on the JAX preparation, carried across by
    ``gen_prepared_from_numpy``, against the JAX prepared solve; the port's
    own prepared solve reproduces its direct solve bitwise."""
    d, _ = jax_solves["general"]
    jprep = jgen.prepare_qp_gen(*_jax([d[0], *d[2:]]), config=_cfg(J))
    j = jgen.solve_qp_gen_prepared(jprep, jnp.asarray(d[1]), config=_cfg(J))
    tprep = gen_prepared_from_numpy(_gen_prepared_fields(jprep),
                                    device="cpu")
    assert tprep.key == jprep.key
    t = T.solve_qp_gen_prepared(tprep, torch.tensor(d[1]), config=_cfg(T))
    _assert_matches(t, j)
    Q, p, A, b, G, h = gen_problem_from_numpy(*d, device="cpu")
    own = T.solve_qp_gen_prepared(T.prepare_qp_gen(Q, A, b, G, h,
                                                   config=_cfg(T)),
                                  p, config=_cfg(T))
    direct = T.solve_qp_gen(Q, p, A, b, G, h, config=_cfg(T))
    assert own.iterations == direct.iterations
    for f in ("x", "lams", "slacks", "nus", "converged"):
        assert torch.equal(getattr(own, f), getattr(direct, f)), f


def test_prepared_key_mismatch_raises_like_jax(jax_solves):
    d, _ = jax_solves["general"]
    jprep = jgen.prepare_qp_gen(*_jax([d[0], *d[2:]]), config=_cfg(J))
    with pytest.raises(ValueError) as theirs:
        jgen.solve_qp_gen_prepared(jprep, jnp.asarray(d[1]),
                                   config=_cfg(J, rho_scale=0.5))
    tprep = gen_prepared_from_numpy(_gen_prepared_fields(jprep),
                                    device="cpu")
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        T.solve_qp_gen_prepared(tprep, torch.tensor(d[1]),
                                config=_cfg(T, rho_scale=0.5))


def test_stateful_genqp_matches_jax(jax_solves):
    """solve / p-only update / warm re-solve / G-update re-solve."""
    d, _ = jax_solves["box"]
    p2 = d[1] * 1.01
    h2 = d[5] * 1.1
    outs = []
    for pkg, conv in ((J, jnp.asarray),
                      (T, lambda a: torch.tensor(np.asarray(a)))):
        Q, p, A, b, G, h = (conv(a) for a in d)
        qp = pkg.GenQP(Q, p, A, b, G, h, control=_cfg(pkg, check_solved=5),
                       warm_start=True)
        sols = []
        for update in ({}, {"p": conv(p2)}, {"h": conv(h2)}):
            qp.update(**update)
            qp.solve()
            sols.append(qp.sol)
        outs.append(sols)
    for j, t in zip(*outs):
        _assert_matches(t, j)
    assert outs[1][1].iterations < outs[1][0].iterations


def test_float32_matches_jax_to_solve_accuracy():
    """float32 at n=130 (two plain leaves on the port's CPU route, Cholesky
    in the JAX package's): x within 2e-3."""
    d = create_qp_data(130, 4, seed=3, dtype=jnp.float32)
    G, h = d.with_G_h()
    args = [np.asarray(a) for a in (d.Q, d.p, d.A, d.b, G, h)]
    kw = dict(eps_abs=1e-5, eps_rel=1e-5)
    j = jgen.solve_qp_gen(*_jax(args), config=J.GenQPConfig(**kw))
    t = T.solve_qp_gen(*gen_problem_from_numpy(*args, device="cpu"),
                       config=T.GenQPConfig(**kw))
    assert t.x.dtype == torch.float32
    assert bool(t.converged.all()) and bool(np.asarray(j.converged).all())
    _close(t.x, j.x, "x", atol=2e-3)


def test_missing_inequalities_raise_like_jax():
    d = _box()
    with pytest.raises(ValueError) as theirs:
        jgen.solve_qp_gen(*_jax(d[:4]), config=_cfg(J))
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        T.solve_qp_gen(*gen_problem_from_numpy(*d[:4], device="cpu"),
                       config=_cfg(T))
