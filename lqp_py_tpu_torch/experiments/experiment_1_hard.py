"""Experiment 1 (hard set): runtime sweep on ill-conditioned sparse QPs.

The port's counterpart of ``experiments/experiment_1_hard.py``, after the
reference's hard-QP benchmark (experiments/experiment_1_hard.py +
``generate_hard_qp_torch``, experiments/utils.py:64-131): sparse-masked Q
with a small ridge, ~sqrt(n_x) random sparse equality rows and
feasible-point-anchored bounds — the regime where iteration counts vary
widely across the batch and adaptive rho matters.  Columns: the three ADMM
modes' fwd+bwd, ADMM without adaptive rho, the box IP, ADMM with Anderson
(window 10), and GenQP's forward gated, rescale-all and with Anderson;
``_*`` fields hold iterations and converged counts.

Writes ``exp1_hard_results_torch.json`` and, where matplotlib is
importable, ``exp1_hard_profile_torch.png`` into ``--out-dir``.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_1_hard \\
          [--sizes 50 100 250 500] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import statistics
from pathlib import Path

import torch

from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, OptNetConfig, boxqp,
                              boxqp_ip, solve_box_qp, solve_box_qp_ip,
                              solve_qp_gen)
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, write_json)
from lqp_py_tpu_torch.experiments.experiment_1 import grad_fn
from lqp_py_tpu_torch.experiments.plotting import plot_profile_bars
from lqp_py_tpu_torch.utils.generators import generate_hard_qp
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

ARTIFACT = "exp1_hard_results_torch.json"
CHART = "exp1_hard_profile_torch.png"


def time_fn(f, *args, n_sims, device):
    """Median wall time of ``f(*args)`` over ``n_sims`` calls after one
    warm-up, each ending in a synchronize."""
    clock(lambda: f(*args), device)
    return statistics.median(clock(lambda: f(*args), device)[1]
                             for _ in range(n_sims))


def hard_data(n_x, n_batch, device, seed=0):
    return generate_hard_qp(n_x, n_batch, seed=seed, dtype=torch.float32,
                            device=device)


def run_size(n_x, n_batch, tol, n_sims, device, data=None):
    device = torch.device(device)
    data = data if data is not None else hard_data(n_x, n_batch, device)
    box = tuple(data)
    out = {}

    def solve(fn, *args, **kw):
        with torch.no_grad():
            return fn(*args, **kw)

    for name, cfg in {
        "ADMM_FP": BoxQPConfig(eps_abs=tol, eps_rel=tol,
                               backward="fixed_point"),
        "ADMM_KKT": BoxQPConfig(eps_abs=tol, eps_rel=tol, backward="kkt"),
        "ADMM_Unroll": BoxQPConfig(eps_abs=tol, eps_rel=tol, unroll=True,
                                   unroll_iters=300, adaptive_rho=False),
        "ADMM_FP_noadapt": BoxQPConfig(eps_abs=tol, eps_rel=tol,
                                       adaptive_rho=False),
    }.items():
        f = grad_fn(lambda *a, cfg=cfg: boxqp(*a, config=cfg))
        out[name] = time_fn(f, *box, n_sims=n_sims, device=device)

    # Interior point on the hard set (the reference runs qpth OptNet here).
    ip_cfg = OptNetConfig(tol=tol, max_iters=40)
    out["BoxIP"] = time_fn(grad_fn(lambda *a: boxqp_ip(*a, config=ip_cfg)),
                           *box, n_sims=n_sims, device=device)
    ipsol = solve(solve_box_qp_ip, *box, config=ip_cfg)
    out["_BoxIP_iters"] = int(ipsol.iterations)
    out["_BoxIP_n_converged"] = int(ipsol.converged.sum())

    # Convergence stats for the default config.
    sol = solve(solve_box_qp, *box, config=BoxQPConfig(eps_abs=tol,
                                                       eps_rel=tol))
    out["_iters"] = int(sol.iterations)
    out["_n_converged"] = int(sol.converged.sum())

    # Anderson-accelerated ADMM (window 10): iterations + wall clock.
    aa_cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol, acceleration=10)
    out["ADMM_FP_aa10"] = time_fn(
        grad_fn(lambda *a: boxqp(*a, config=aa_cfg)), *box, n_sims=n_sims,
        device=device)
    aasol = solve(solve_box_qp, *box, config=aa_cfg)
    out["_aa10_iters"] = int(aasol.iterations)
    out["_aa10_n_converged"] = int(aasol.converged.sum())

    # Convergence record of the no-adapt ablation (the timed config above).
    na_sol = solve(solve_box_qp, *box, config=BoxQPConfig(
        eps_abs=tol, eps_rel=tol, adaptive_rho=False))
    out["_noadapt_iters"] = int(na_sol.iterations)
    out["_noadapt_n_converged"] = int(na_sol.converged.sum())

    # GenQP on the same problems (G = [-I; I]): the per-element adaptive-rho
    # gate against the reference's rescale-all, and the forward wall clock
    # of the gated and Anderson-accelerated configs.
    G, h = data.with_G_h()
    gh = (data.Q, data.p, data.A, data.b, G, h)
    for name, gcfg, timed in (
        ("GenQP_gated", GenQPConfig(eps_abs=tol, eps_rel=tol,
                                    adaptive_rho_per_element=True), True),
        ("GenQP_rescale_all",
         GenQPConfig(eps_abs=tol, eps_rel=tol,
                     adaptive_rho_per_element=False), False),
        # Safeguarded Anderson acceleration (SCS acceleration_lookback).
        ("GenQP_aa10", GenQPConfig(eps_abs=tol, eps_rel=tol,
                                   acceleration=10), True),
    ):
        gsol = solve(solve_qp_gen, *gh, config=gcfg)
        out[f"_{name}_iters"] = int(gsol.iterations)
        out[f"_{name}_n_converged"] = int(gsol.converged.sum())
        if timed:
            out[name] = time_fn(
                lambda *a, gcfg=gcfg: solve(solve_qp_gen, *a,
                                            config=gcfg).x,
                *gh, n_sims=n_sims, device=device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[50, 100, 250, 500])
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--n-sims", type=int, default=5)
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    for n_x in args.sizes:
        r = run_size(n_x, args.n_batch, args.tol, args.n_sims, device)
        results[n_x] = r
        print(f"n_x={n_x}: " + "  ".join(
            f"{k}={v:.4f}s" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items()), flush=True)

    write_json(args.out_dir, ARTIFACT, {
        "device": device_label(device), "torch": torch.__version__,
        "n_batch": args.n_batch, "tol": args.tol, "n_sims": args.n_sims,
        "results": results})
    timings = {s: {k: v for k, v in r.items() if not k.startswith("_")}
               for s, r in results.items()}
    path = Path(args.out_dir) / CHART
    if plot_profile_bars(timings, path,
                         title="hard-QP set (batch=%d, tol=%g)"
                               % (args.n_batch, args.tol)):
        print(f"wrote {path}")
    else:
        print("(no chart: matplotlib is not importable)")
    return results


if __name__ == "__main__":
    main()
