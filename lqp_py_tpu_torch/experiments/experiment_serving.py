"""Serving / MPC-style benchmark: repeated solves under slowly drifting
problem data, cold-start vs warm-start.

The port's counterpart of ``experiments/experiment_serving.py``.  The
reference's ``BoxQPTH`` class hints at a solve/update/re-solve workflow
but always cold-starts from zeros (solve_box_qp_admm_torch.py:221-223).
Here ``prepare_box_qp`` caches the scaling and the factorization (Q, A and
the bounds fixed, only p drifting) and ``solve_box_qp_prepared`` re-uses
the previous (x, z, u), which for a drifting cost vector collapses the
iteration count to near the check interval.  Per step: a cold direct solve
and a prepared warm-started one, each timed alone.  Then the whole horizon
of prepared warm-started solves back to back in one timed window (the
JAX driver's fused ``lax.scan`` rollout; here the solves are queued one
after another and synchronized once), for the box ADMM and for GenQP
(``prepare_qp_gen`` + ``solve_qp_gen_prepared``).

Writes ``exp_serving_results_torch.json`` into ``--out-dir``.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_serving \\
          [--n-x 500 --steps 20] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import statistics

import torch

from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, prepare_box_qp,
                              prepare_qp_gen, solve_box_qp,
                              solve_box_qp_prepared, solve_qp_gen_prepared)
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, write_json)
from lqp_py_tpu_torch.utils.generators import create_qp_data
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

ARTIFACT = "exp_serving_results_torch.json"


def make_problem(n_x, n_batch, steps, device, seed=0):
    """The served family (f32) and the per-step drift directions, both
    from the port's generator stream on ``device``."""
    data = create_qp_data(n_x, n_batch, seed=seed, dtype=torch.float32,
                          device=device)
    g = torch.Generator(device=device).manual_seed(1)
    drifts = torch.randn((steps,) + tuple(data.p.shape), generator=g,
                         dtype=torch.float32, device=device)
    return data, drifts


def serve_steps(data, drifts, drift, cfg, device):
    """Per step, p += drift * drifts[t]: a cold direct solve and a prepared
    warm-started one (from the previous step's), each timed alone after one
    warm-up of each.  Returns the per-step records, the preparation and the
    cold solution at the first p (the rollout's start)."""
    Q, p0, A, b, lb, ub = data
    prep = prepare_box_qp(Q, A, b, lb, ub, config=cfg)
    sol0, _ = clock(lambda: solve_box_qp(Q, p0, A, b, lb, ub, cfg), device)
    clock(lambda: solve_box_qp_prepared(prep, p0, config=cfg,
                                        warm_start=sol0), device)
    out = {"cold": [], "warm": [], "cold_iters": [], "warm_iters": []}
    prev, p = sol0, p0
    for dp in drifts:
        p = p + drift * dp
        s_c, t_c = clock(lambda: solve_box_qp(Q, p, A, b, lb, ub, cfg),
                         device)
        s_w, t_w = clock(lambda: solve_box_qp_prepared(
            prep, p, config=cfg, warm_start=prev), device)
        out["cold"].append(t_c)
        out["cold_iters"].append(int(s_c.iterations))
        out["warm"].append(t_w)
        out["warm_iters"].append(int(s_w.iterations))
        prev = s_w
    return out, prep, sol0


def rollout(solve_prepared, prep, p0, drifts, drift, sol0, cfg, device):
    """The whole horizon of warm-started prepared solves in one timed
    window (after one untimed pass): seconds per solve and each solve's
    iterations."""
    def run():
        p, prev, iters = p0, sol0, []
        for dp in drifts:
            p = p + drift * dp
            prev = solve_prepared(prep, p, config=cfg, warm_start=prev)
            iters.append(int(prev.iterations))
        return iters

    clock(run, device)
    iters, t = clock(run, device)
    return t / len(drifts), iters


def genqp_rollout(data, drifts, drift, tol, device):
    """The same serving shape for the general-inequality solver."""
    Q, p0, A, b = data.Q, data.p, data.A, data.b
    G, h = data.with_G_h()
    gcfg = GenQPConfig(eps_abs=tol, eps_rel=tol)
    gprep = prepare_qp_gen(Q, A, b, G, h, config=gcfg)
    sol0, _ = clock(lambda: solve_qp_gen_prepared(gprep, p0, config=gcfg),
                    device)
    return rollout(solve_qp_gen_prepared, gprep, p0, drifts, drift, sol0,
                   gcfg, device)


def run(n_x, n_batch, steps, drift, tol, device):
    device = torch.device(device)
    data, drifts = make_problem(n_x, n_batch, steps, device)
    cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol)
    results, prep, sol0 = serve_steps(data, drifts, drift, cfg, device)
    results["fused_per_solve"], results["fused_iters"] = rollout(
        solve_box_qp_prepared, prep, data.p, drifts, drift, sol0, cfg,
        device)
    del prep, sol0
    (results["genqp_fused_per_solve"],
     results["genqp_fused_iters"]) = genqp_rollout(data, drifts, drift, tol,
                                                   device)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--drift", type=float, default=0.02)
    ap.add_argument("--tol", type=float, default=1e-5)
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = run(args.n_x, args.n_batch, args.steps, args.drift, args.tol,
                  device)
    med_c = statistics.median(results["cold"])
    med_w = statistics.median(results["warm"])
    t_fused = results["fused_per_solve"]
    print(f"n_x={args.n_x} batch={args.n_batch} drift={args.drift} "
          f"tol={args.tol}")
    print(f"cold: median {med_c*1e3:.1f} ms/solve, "
          f"iters {statistics.median(results['cold_iters'])}")
    print(f"warm: median {med_w*1e3:.1f} ms/solve, "
          f"iters {statistics.median(results['warm_iters'])}  "
          f"({med_c/med_w:.2f}x faster)")
    print(f"rollout (all {args.steps} steps in one timed window): "
          f"{t_fused*1e3:.1f} ms/solve, "
          f"iters {statistics.median(results['fused_iters'])}  "
          f"({med_c/t_fused:.2f}x faster than cold)")
    print(f"genqp rollout: {results['genqp_fused_per_solve']*1e3:.1f} "
          f"ms/solve, iters {statistics.median(results['genqp_fused_iters'])}")
    write_json(args.out_dir, ARTIFACT, {
        "device": device_label(device), "torch": torch.__version__,
        "n_x": args.n_x, "n_batch": args.n_batch, "drift": args.drift,
        "tol": args.tol, **results})
    return results


if __name__ == "__main__":
    main()
