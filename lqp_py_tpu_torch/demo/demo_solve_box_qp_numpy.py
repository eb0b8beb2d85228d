"""Demo: single-problem numpy ADMM solver + cross-check vs the port.

The port's counterpart of ``demo/demo_solve_box_qp_numpy.py`` (after the
reference numpy demo, demo/demo_solve_box_qp.py, which solves one QP with
the scipy-based ADMM and eyeballs it against cvxpy).  The numpy solver is
the port's own copy (``lqp_py_tpu_torch/cpu/boxqp_numpy.py``); the trusted
cross-checks are the batched solver of the port (float64) and the native
C++ CPU solver where it builds.

Run:  python -m lqp_py_tpu_torch.demo.demo_solve_box_qp_numpy [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lqp_py_tpu_torch import BoxQPConfig, solve_box_qp
from lqp_py_tpu_torch.cpu import native
from lqp_py_tpu_torch.cpu.boxqp_numpy import BoxQPNumpy
from lqp_py_tpu_torch.utils.generators import create_qp_data
from lqp_py_tpu_torch.utils.profiling import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    data = create_qp_data(args.n_x, 1, seed=0, dtype=torch.float64,
                          device=resolve_device(args.device))
    Q, p, A, b, lb, ub = (t[0].cpu().numpy() for t in data)

    # The numpy single-problem solver (solve / update / re-solve workflow).
    prob = BoxQPNumpy(Q, p, A, b, lb, ub, eps_abs=1e-8, eps_rel=1e-8)
    x_np = prob.solve()
    sol = prob.sol
    print(f"numpy ADMM: iters={sol['iter']}  "
          f"primal={sol['primal_error']:.2e}  dual={sol['dual_error']:.2e}")

    # Against the port's batched solver.
    tsol = solve_box_qp(*data, config=BoxQPConfig(eps_abs=1e-8,
                                                  eps_rel=1e-8))
    dx = float(np.max(np.abs(x_np - tsol.x[0].cpu().numpy())))
    print(f"max |x_numpy - x_torch| = {dx:.2e}")
    if not dx < 1e-5:
        raise AssertionError("numpy and torch solvers disagree")

    # Against the native C++ solver, where it builds.
    if native.available():
        nsol = native.solve_box_qp_native(
            *(t.cpu().numpy() for t in data), eps_abs=1e-8, eps_rel=1e-8)
        print(f"max |x_native - x_numpy| = "
              f"{float(np.max(np.abs(nsol['x'][0] - x_np))):.2e}")
    else:
        print("native solver unavailable (no g++); skipped")

    # Update p and re-solve (the warm workflow the reference hints at).
    prob.update(p=p * 0.5)
    prob.solve()
    print(f"re-solve after update: iters={prob.sol['iter']}")
    print("demo OK")
    return dx


if __name__ == "__main__":
    main()
