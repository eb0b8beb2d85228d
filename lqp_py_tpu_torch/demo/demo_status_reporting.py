"""Demo: per-element solver status — convergence, residuals, and
primal-infeasibility certificates.

The port's counterpart of ``demo/demo_status_reporting.py``.  The
reference returns the current iterate silently after max_iters
(solve_box_qp_admm_torch.py:331) with no status of any kind.  Here every
``BoxQPSolution`` carries per-element ``converged``, ``primal_residual``,
``dual_residual`` and ``iterations``, and the solver detects primal
infeasibility (OSQP-style certificate, Banjac et al. 2019) instead of
burning the full iteration budget.  ``BoxQPConfig(residual_trace=K)``
keeps the last K residual checks in ``solution.residual_trace``.

Run:  python -m lqp_py_tpu_torch.demo.demo_status_reporting [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from lqp_py_tpu_torch import BoxQPConfig, solve_box_qp
from lqp_py_tpu_torch.utils.profiling import resolve_device


def problems(device, n=6):
    """Three box QPs with one sum row: element 1 is infeasible (sum x = 30
    with x <= 1 and n = 6), elements 0 and 2 are feasible."""
    g = torch.Generator(device=device).manual_seed(0)
    kw = dict(dtype=torch.float32, device=device)
    L = torch.randn((3, 2 * n, n), generator=g, **kw)
    Q = L.mT @ L / (2 * n) + 0.5 * torch.eye(n, **kw)
    p = torch.randn((3, n), generator=g, **kw)
    A = torch.ones((3, 1, n), **kw)
    b = torch.tensor([[2.0], [30.0], [-1.0]], **kw)
    lb = torch.full((3, n), -1.0, **kw)
    ub = torch.full((3, n), 1.0, **kw)
    return Q, p, A, b, lb, ub


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    data = problems(resolve_device(args.device))

    sol = solve_box_qp(*data, config=BoxQPConfig(
        eps_abs=1e-6, eps_rel=1e-6, max_iters=20000))
    print(f"iterations run (lock-step batch): {int(sol.iterations)}")
    for i in range(3):
        status = ("PRIMAL INFEASIBLE (certificate found)"
                  if bool(sol.primal_infeasible[i])
                  else ("converged" if bool(sol.converged[i])
                        else "max-iters"))
        print(f"  element {i}: {status:38s} "
              f"primal={float(sol.primal_residual[i]):.2e} "
              f"dual={float(sol.dual_residual[i]):.2e}")
    if not (bool(sol.primal_infeasible[1]) and bool(sol.converged[0])):
        raise AssertionError("element 1 must be certified infeasible and "
                             "element 0 converged")
    print("ok: infeasibility certified without burning max_iters "
          f"({int(sol.iterations)} << 20000)")

    # The residual trajectory of the last 16 checks, carried through the
    # solve in the solution (no host callback inside the loop).
    sol_t = solve_box_qp(*data, config=BoxQPConfig(
        eps_abs=1e-6, eps_rel=1e-6, max_iters=20000, residual_trace=16))
    print("\nresidual trajectory (last 16 checks, solution.residual_trace):")
    tr = sol_t.residual_trace.cpu()
    for it, pe, de in tr[tr[:, 0] >= 0].tolist():
        print(f"  iter {int(it):5d}  max primal={pe:.3e}  max dual={de:.3e}")
    return sol, tr


if __name__ == "__main__":
    main()
