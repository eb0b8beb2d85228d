"""Box Anderson's iteration counts on the hard family in float64: the
port's against JAX's, each held to the other's rounding spread.

On the Anderson driver's hard family (``generate_hard_qp``, here n=16,
B=4, tol 1e-5) the plain box ADMM and GenQP with and without Anderson take
JAX's counts exactly in f64 (tests/test_torch_experiments_train.py), but
the box Anderson counts part: on seed 0, 125 against 122 at window 10 and
206 against 296 at window 20.  These tests show that the gap is rounding
far from balance and not a fault of the port's safeguard: six one-ulp
nudges of the input (p by a random ±ulp per entry, four times; Q by +ulp
and by -ulp, symmetric) move JAX's own counts as far, and the port's
under the same nudges spread over the same range.  Each package's count
on the plain input must lie within the span of the other's counts over
the plain and the nudged inputs, window by window; on seed 1, where
nothing moves, that makes them equal.

Run as a script (``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_experiments_aa.py [SEED ...]`` from the repository root)
it prints both packages' counts per seed and window.  Seeds 2 and 3 are
left out of the tests: one element of each (a feasible problem, Q's
least eigenvalue 0.01) diverges within 25 iterations of the plain box
ADMM in both packages and ends as NaN, so their Anderson counts say where
a diverging trajectory happens to be rescued, not how the safeguard
behaves.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lqp_py_tpu as J
from lqp_py_tpu.utils.generators import generate_hard_qp as j_hard
from lqp_py_tpu_torch import BoxQPConfig, solve_box_qp
from _torch_threads import one_torch_thread  # noqa: F401
from lqp_py_tpu_torch.utils.convert import problem_from_numpy

N, B, TOL = 16, 4, 1e-5
WINDOWS = (10, 20)


def nudged(arrays):
    """Six copies of the problem, each one ulp away in p or in Q."""
    out = []
    for k in range(6):
        a = [x.copy() for x in arrays]
        if k < 4:
            up = np.random.RandomState(k).rand(*a[1].shape) < 0.5
            a[1] = np.nextafter(a[1], np.where(up, np.inf, -np.inf))
        else:
            Q = np.nextafter(a[0], np.inf if k == 4 else -np.inf)
            a[0] = np.triu(Q) + np.swapaxes(np.triu(Q, 1), -1, -2)
        out.append(a)
    return out


def counts(seed, window):
    """``{package: [count on the plain input, counts on the six nudged
    ones]}`` of the f64 box ADMM with Anderson window ``window``."""
    arrays = [np.asarray(a) for a in j_hard(N, B, seed=seed,
                                            dtype=jnp.float64)]
    inputs = [arrays, *nudged(arrays)]
    cfg = J.BoxQPConfig(eps_abs=TOL, eps_rel=TOL, acceleration=window)
    jax_solve = jax.jit(lambda *a: J.solve_box_qp(*a, config=cfg))
    ours = BoxQPConfig(eps_abs=TOL, eps_rel=TOL, acceleration=window)
    return {
        "jax": [int(jax_solve(*a).iterations) for a in inputs],
        "port": [int(solve_box_qp(*problem_from_numpy(*a, device="cpu"),
                                  config=ours).iterations) for a in inputs]}


@pytest.mark.parametrize("seed", [0, 1])
def test_box_anderson_hard_counts_within_each_others_rounding(seed):
    for window in WINDOWS:
        c = counts(seed, window)
        for mine, other in (("port", "jax"), ("jax", "port")):
            lo, hi = min(c[other]), max(c[other])
            assert lo <= c[mine][0] <= hi, (window, c)


def plain_readings(seed):
    """Per element of the seed's f64 problems: feasible (by an LP), Q's
    least eigenvalue, and each package's max|x| after 25 iterations, and
    whether x is NaN and whether it converged after the plain box ADMM's
    10000."""
    from scipy.optimize import linprog
    Q, p, A, b, lb, ub = arrays = [
        np.asarray(a) for a in j_hard(N, B, seed=seed, dtype=jnp.float64)]
    out = {"feasible": [linprog(np.zeros(N), A_eq=A[i], b_eq=b[i],
                                bounds=list(zip(lb[i], ub[i])),
                                method="highs").status == 0
                        for i in range(B)],
           "least_eig": np.linalg.eigvalsh(Q).min(axis=-1).round(4)}
    for k in (25, 10000):
        theirs = J.solve_box_qp(*arrays, config=J.BoxQPConfig(
            eps_abs=TOL, eps_rel=TOL, max_iters=k))
        ours = solve_box_qp(*problem_from_numpy(*arrays, device="cpu"),
                            config=BoxQPConfig(eps_abs=TOL, eps_rel=TOL,
                                               max_iters=k))
        for name, sol in (("jax", theirs), ("port", ours)):
            if k == 25:
                out[f"{name} max|x| at 25"] = np.abs(
                    np.asarray(sol.x)).max(axis=-1).round(1)
            else:
                out[f"{name} NaN"] = np.isnan(np.asarray(sol.x)).any(axis=-1)
                out[f"{name} converged"] = np.asarray(sol.converged)
    return out


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    for seed in map(int, sys.argv[1:] or ["0", "1", "2", "3"]):
        print(f"seed {seed} plain: " + "; ".join(
            f"{k} {v}" for k, v in plain_readings(seed).items()), flush=True)
        for window in (0, *WINDOWS):
            c = counts(seed, window)
            print(f"seed {seed} window {window}: "
                  + "; ".join(f"{k} {v[0]}, nudged {v[1:]}"
                              for k, v in c.items()), flush=True)
