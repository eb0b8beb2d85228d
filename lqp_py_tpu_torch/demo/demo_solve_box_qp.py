"""Demo: raw functional forward + manual backward on a batch of box QPs.

The port's counterpart of ``demo/demo_solve_box_qp.py`` (after the
reference demo, demo/demo_solve_box_qp_torch.py): dz=500, batch=128, tol
1e-6, with residual printing, the fixed-point backward called by hand,
and a cross-check against the native C++ CPU solver where it builds.

Run:  python -m lqp_py_tpu_torch.demo.demo_solve_box_qp \\
          [--n-x 500 --n-batch 128] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lqp_py_tpu_torch import BoxQPConfig, solve_box_qp
from lqp_py_tpu_torch.cpu import native
from lqp_py_tpu_torch.models.box_qp_grad import box_qp_grad_fixed_point
from lqp_py_tpu_torch.utils.generators import create_qp_data, kkt_residuals
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol, verbose=False)
    data = create_qp_data(args.n_x, args.n_batch, seed=0,
                          dtype=torch.float32, device=dev)

    _, t = clock(lambda: solve_box_qp(*data, config=cfg), dev)
    print(f"first solve: {t:.3f}s")
    sol, t = clock(lambda: solve_box_qp(*data, config=cfg), dev)
    print(f"forward: {t:.3f}s  iters={int(sol.iterations)} "
          f"converged={bool(sol.converged.all())}")

    res = kkt_residuals(*data, sol.x, sol.lams, sol.nus)
    for k, v in res.items():
        print(f"  max {k}: {float(v.max()):.3e}")

    # The backward called by hand (the layer's autograd Function does this).
    dl_dz = torch.ones_like(sol.x)

    def bwd():
        return box_qp_grad_fixed_point(dl_dz, sol.x, sol.u, sol.lams,
                                       sol.nus, data.Q, data.A, data.lb,
                                       data.ub, sol.rho)
    clock(bwd, dev)
    grads, t = clock(bwd, dev)
    print(f"backward: {t:.3f}s  |dQ|={float(grads[0].abs().max()):.3e} "
          f"|dp|={float(grads[1].abs().max()):.3e}")

    # Cross-check a few elements against the native CPU solver.
    if native.available():
        k = min(4, args.n_batch)
        out = native.solve_box_qp_native(
            *(t[:k].detach().cpu().double().numpy() for t in data),
            eps_abs=1e-9, eps_rel=1e-9)
        err = float(np.max(np.abs(sol.x[:k].double().cpu().numpy()
                                  - out["x"])))
        print(f"max |x - x_native_cpu| over {k} elements: {err:.3e}")
        return err
    print("native CPU solver unavailable (no g++); cross-check skipped")
    return None


if __name__ == "__main__":
    main()
