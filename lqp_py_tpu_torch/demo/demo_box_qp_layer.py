"""Demo: the differentiable layer with all three backward modes.

The port's counterpart of ``demo/demo_box_qp_layer.py`` (after the
reference demo, demo/demo_solve_box_qp_torch_layer.py:25-78): dz=1000,
gradients with respect to Q and p of sum(x) through ``BoxQPLayer`` in the
fixed-point, KKT and unrolled modes, each compared with the fixed-point
one.

Run:  python -m lqp_py_tpu_torch.demo.demo_box_qp_layer \\
          [--n-x 1000 --n-batch 32] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from lqp_py_tpu_torch import BoxQPConfig, BoxQPLayer
from lqp_py_tpu_torch.utils.generators import create_qp_data
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=1000)
    ap.add_argument("--n-batch", type=int, default=32)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = create_qp_data(args.n_x, args.n_batch, seed=0,
                          dtype=torch.float32, device=dev)
    modes = {
        "fixed_point": BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol,
                                   backward="fixed_point"),
        "kkt": BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol,
                           backward="kkt"),
        "unroll": BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol,
                              unroll=True, unroll_iters=200,
                              adaptive_rho=False),
    }

    grads = {}
    for name, cfg in modes.items():
        layer = BoxQPLayer(cfg)

        def fwd_bwd():
            Q = data.Q.clone().requires_grad_(True)
            p = data.p.clone().requires_grad_(True)
            x = layer(Q, p, data.A, data.b, data.lb, data.ub)
            return torch.autograd.grad(x.sum(), (Q, p))

        clock(fwd_bwd, dev)
        g, t = clock(fwd_bwd, dev)
        grads[name] = g
        print(f"{name:12s}: fwd+bwd {t:.3f}s  "
              f"|dQ|max={float(g[0].abs().max()):.4e}  "
              f"|dp|max={float(g[1].abs().max()):.4e}")

    ref = grads["fixed_point"]
    diffs = {}
    for name in ("kkt", "unroll"):
        dq = float((grads[name][0] - ref[0]).abs().max())
        dp = float((grads[name][1] - ref[1]).abs().max())
        diffs[name] = (dq, dp)
        print(f"{name} vs fixed_point: max|dQ diff|={dq:.2e} "
              f"max|dp diff|={dp:.2e}")
    return diffs


if __name__ == "__main__":
    main()
