"""Experiment 1 (paper variant): runtime vs TOLERANCE at a fixed size.

The port's counterpart of ``experiments/experiment_1_paper.py`` (itself
the reference's ``experiments/experiment_1_paper.py``): dz=500, batch=128,
every solver family timed at eps in {1e-1, 1e-3, 1e-5} (the reference's
15-column "ADMM FP 1 / 3 / 5 ..." chart, its paper's Figure 3 protocol),
with Experiment 1's protocol (``experiment_1.time_split``).  The tight
column (1e-5) is gated against the tight ADMM reference.

Writes ``exp1_paper_results_torch.json`` and, where matplotlib is
importable, ``exp1_paper_times_torch.(png|pdf)`` into ``--out-dir``.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_1_paper \\
          [--n-x 500] [--n-sims 10] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, OptNetConfig, boxqp,
                              qp_gen, qp_optnet, solve_box_qp)
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, write_json)
from lqp_py_tpu_torch.experiments.experiment_1 import (box_args, fwd_fn,
                                                       gh_args, grad_fn,
                                                       quality_gate,
                                                       seeded_data,
                                                       tight_reference,
                                                       time_split)
from lqp_py_tpu_torch.experiments.plotting import plot_profile_bars
from lqp_py_tpu_torch.utils.profiling import resolve_device

ARTIFACT = "exp1_paper_results_torch.json"
CHART = "exp1_paper_times_torch"

TOLS = (1e-1, 1e-3, 1e-5)


def tol_modes(tol):
    """``{column: (layer call, argument maker)}`` at one tolerance, named
    by its digit (ADMM_FP_5 at 1e-5)."""
    digit = f"{-round(math.log10(tol))}"
    box = {
        f"ADMM_FP_{digit}": BoxQPConfig(
            eps_abs=tol, eps_rel=tol, symmetrize=False),
        f"ADMM_KKT_{digit}": BoxQPConfig(
            eps_abs=tol, eps_rel=tol, symmetrize=False, backward="kkt"),
        f"ADMM_Unroll_{digit}": BoxQPConfig(
            eps_abs=tol, eps_rel=tol, symmetrize=False, unroll=True,
            unroll_iters=60, adaptive_rho=False),
    }
    calls = {name: ((lambda Q, p, A, b, lb, ub, cfg=cfg: boxqp(
        Q, p, A, b, lb, ub, config=cfg)), box_args)
        for name, cfg in box.items()}
    # Interior point (the reference times qpth/OptNet here).
    ip_cfg = OptNetConfig(tol=tol, symmetrize=False)
    calls[f"OptNet_{digit}"] = ((lambda Q, p, A, b, G, h: qp_optnet(
        Q, p, A, b, G, h, config=ip_cfg)), gh_args)
    # Operator splitting (the reference times SCS here).
    gen_cfg = GenQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False)
    calls[f"GenQP_{digit}"] = ((lambda Q, p, A, b, G, h: qp_gen(
        Q, p, A, b, G, h, config=gen_cfg)), gh_args)
    return digit, box[f"ADMM_FP_{digit}"], calls


def run_tol_sweep(n_x, n_batch, n_sims, device, data_for_seed=None,
                  tols=TOLS):
    device = torch.device(device)
    data_for_seed = data_for_seed or seeded_data(n_x, n_batch, device)
    data0 = data_for_seed(0)
    x_tight = tight_reference(data0)
    out = {}
    for tol in tols:
        digit, fp_cfg, calls = tol_modes(tol)
        for name, (call, make_args) in calls.items():
            out[name] = time_split(fwd_fn(call), grad_fn(call),
                                   lambda s: make_args(data_for_seed(s)),
                                   n_sims, device)
            out[name]["tol"] = tol
        with torch.no_grad():
            sol0 = solve_box_qp(*box_args(data0), config=fp_cfg)
        rec = {"max_dev_x_vs_tight": float(
                   (sol0.x.double() - x_tight.double()).abs().max()),
               "n_converged": int(sol0.converged.sum()),
               "n_problems": int(sol0.converged.shape[0]),
               "iterations": int(sol0.iterations)}
        # Only the tight column must match the tight reference closely;
        # loose tolerances legitimately deviate ~O(tol).
        if tol <= 1e-5:
            quality_gate(f"ADMM_FP_{digit}", sol0.x, x_tight,
                         sol0.converged, sol0.iterations)
        out[f"ADMM_FP_{digit}"].update(rec)
        out[f"ADMM_KKT_{digit}"].update(rec)
        print(f"[exp1_paper] tol={tol:g} done", file=sys.stderr, flush=True)
    return out


def plot(res, out_dir, n_x, n_batch):
    # One bar group per tolerance digit.
    grouped = {}
    for name, rec in res.items():
        base, digit = name.rsplit("_", 1)
        grouped.setdefault(int(digit), {})[base] = rec["total"]
    for ext in ("png", "pdf"):
        path = Path(out_dir) / f"{CHART}.{ext}"
        if not plot_profile_bars(
                grouped, path, title=f"fwd+bwd vs tolerance (dz={n_x}, "
                f"B={n_batch}); x = -log10(eps)"):
            print("(no chart: matplotlib is not importable)")
            return
        print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--n-sims", type=int, default=10)
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    res = run_tol_sweep(args.n_x, args.n_batch, args.n_sims, device)
    write_json(args.out_dir, ARTIFACT, {
        "protocol": {
            "n_x": args.n_x, "n_batch": args.n_batch,
            "n_sims": args.n_sims, "tols": list(TOLS),
            "device": device_label(device), "torch": torch.__version__,
            "reference": "experiments/experiment_1_paper.py (dz=500, "
                         "tol sweep 1e-1/1e-3/1e-5, median of 10 sims)",
        },
        "results": res,
    })
    print(json.dumps({k: round(v["total"], 4) for k, v in res.items()}))
    plot(res, args.out_dir, args.n_x, args.n_batch)
    return res


if __name__ == "__main__":
    main()
