"""Straggler-skewed serving benchmark: the per-element early-exit kernel.

The port's counterpart of ``experiments/experiment_straggler.py``.  With
``use_pallas_step=True`` the box ADMM's x-update runs the early-exit GEMV
kernel (``csrc/gemv_early_exit.cu``), which never reads a converged
element's (n, n) operator panel; the lock-step path (``xla_step``, the JAX
column's name) runs the plain batched GEMV.  The workload it exists for is
a serving batch where a few ill-conditioned stragglers keep the loop alive
long after the bulk of the batch has converged.

Batch: all ``n_batch`` problems come from the hard generator (so the
equality blocks share one shape); all but ``n_hard`` of them get a ridge
``mean(diag Q) * I`` added, which makes them converge in a few dozen
iterations while the un-ridged stragglers need hundreds.  Both columns
must converge the same number of problems; the largest x difference
between them is recorded.

Writes ``exp_straggler_results_torch.json`` into ``--out-dir``, merged by
size with the sizes already there from the same device.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_straggler \\
          [--n-x 500 --n-hard 8] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from lqp_py_tpu_torch import BoxQPConfig, solve_box_qp
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, gate,
                                                  read_json, write_json)
from lqp_py_tpu_torch.utils.generators import generate_hard_qp
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

ARTIFACT = "exp_straggler_results_torch.json"


def hard_data(n_x, n_batch, device, seed=0):
    return generate_hard_qp(n_x, n_batch, seed=seed, dtype=torch.float32,
                            device=device)


def ridge_easy(Q, n_hard):
    """Ridge the leading ``B - n_hard`` elements into easy problems with
    ``mean(diag Q) * I``; the bounds stay feasible (they are anchored to a
    point of Ax = b, which does not involve Q)."""
    B, n = Q.shape[0], Q.shape[-1]
    ridge = Q.diagonal(dim1=-2, dim2=-1).mean(dim=-1)          # (B,)
    is_easy = torch.arange(B, device=Q.device) < B - n_hard
    return Q + torch.where(is_easy, ridge, 0.0)[:, None, None] * torch.eye(
        n, dtype=Q.dtype, device=Q.device)


def mixed_batch(n_x, n_batch, n_hard, device, seed=0):
    hard = hard_data(n_x, n_batch, device, seed)
    return (ridge_easy(hard.Q, n_hard), *hard[1:])


def configs(tol, max_iters):
    base = dict(eps_abs=tol, eps_rel=tol, symmetrize=False,
                max_iters=max_iters)
    return {"xla_step": BoxQPConfig(**base),
            "pallas_step": BoxQPConfig(**base, use_pallas_step=True)}


def time_column(args, cfg, n_reps, device):
    """The solve's median wall time over ``n_reps`` after one warm-up, and
    the warm-up's solution."""
    def solve():
        with torch.no_grad():
            return solve_box_qp(*args, config=cfg)

    sol, _ = clock(solve, device)
    ts = [clock(solve, device)[1] for _ in range(n_reps)]
    return sol, {"median_s": statistics.median(ts), "times": ts,
                 "iterations": int(sol.iterations),
                 "n_converged": int(sol.converged.sum()),
                 "n_problems": int(sol.converged.shape[0])}


def run(args, n_hard, tol, n_reps, max_iters, device):
    """Both columns on the batch ``args``; raises unless they converge the
    same number of problems."""
    n_batch, n_x = args[1].shape
    out = {"n_x": n_x, "n_batch": n_batch, "n_hard": n_hard, "tol": tol,
           "device": device_label(torch.device(device)),
           "torch": torch.__version__}
    sols = {}
    for name, cfg in configs(tol, max_iters).items():
        sols[name], out[name] = time_column(args, cfg, n_reps, device)
        print(f"{name:12s} {out[name]['median_s']*1e3:7.1f} ms  "
              f"iters={out[name]['iterations']}  converged="
              f"{out[name]['n_converged']}/{out[name]['n_problems']}",
              file=sys.stderr, flush=True)
    # Both paths must solve the same problems to the same tolerance.
    dx = float((sols["xla_step"].x - sols["pallas_step"].x).abs().max())
    out["max_dx_between_paths"] = dx
    gate(out["xla_step"]["n_converged"] == out["pallas_step"]["n_converged"],
         f"straggler: lock-step converged {out['xla_step']['n_converged']} "
         f"problems, early-exit {out['pallas_step']['n_converged']}")
    out["pallas_speedup"] = (out["xla_step"]["median_s"]
                             / out["pallas_step"]["median_s"])
    print(f"early-exit speedup on the straggler batch: "
          f"{out['pallas_speedup']:.2f}x  (paths agree to {dx:.2e})",
          file=sys.stderr)
    return out


def merge(out_dir, out):
    """This size over the artifact's results from the same device, so the
    winning (n=1000) and losing (n=500) regimes both stay on record."""
    old = read_json(Path(out_dir) / ARTIFACT) or {}
    results = {k: v for k, v in old.get("results", {}).items()
               if v.get("device") == out["device"]}
    results[str(out["n_x"])] = out
    return {"results": results}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--n-hard", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--n-reps", type=int, default=7)
    ap.add_argument("--max-iters", type=int, default=4000)
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    batch = mixed_batch(args.n_x, args.n_batch, args.n_hard, device)
    out = run(batch, args.n_hard, args.tol, args.n_reps, args.max_iters,
              device)
    write_json(args.out_dir, ARTIFACT, merge(args.out_dir, out))
    print(json.dumps({"pallas_speedup": round(out["pallas_speedup"], 3),
                      "xla_ms": round(out["xla_step"]["median_s"] * 1e3, 1),
                      "pallas_ms": round(
                          out["pallas_step"]["median_s"] * 1e3, 1)}))
    return out


if __name__ == "__main__":
    main()
