"""IP accuracy/time tradeoff: the refine_steps x polish sweep.

The port's counterpart of ``experiments/experiment_ip_accuracy.py``.  Runs
both interior points (general OptNet with the box as G = [-I; I], and the
box-structured one) over refine_steps in {0, 1, 2} x polish in {off, on},
plus ADMM at the same tolerance with and without polish, recording

  - max |x - x_f64| on the first ``--n-oracle`` problems, where x_f64 is
    the independent numpy/scipy float64 scalar ADMM
    (``lqp_py_tpu_torch/cpu/boxqp_numpy.py``) at eps 1e-9 (reference
    accuracy comparator: the reference's lqp_py/optnet.py:116-125);
  - max |x - x_tight_f32| over the whole batch (secondary; a tight f32
    ADMM solve, whose own floor is ~4e-3 at dz=1000);
  - the median forward wall clock.

Writes ``ip_accuracy_results_torch.json`` into ``--out-dir``.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_ip_accuracy \\
          [--sizes 500 1000] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from lqp_py_tpu_torch import (BoxQPConfig, OptNetConfig, solve_box_qp,
                              solve_box_qp_ip, solve_qp_optnet)
from lqp_py_tpu_torch.cpu.boxqp_numpy import solve_box_qp_np
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, gate,
                                                  write_json)
from lqp_py_tpu_torch.utils.generators import QPData, create_qp_data
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

ARTIFACT = "ip_accuracy_results_torch.json"
COMPARATOR = ("numpy/scipy f64 scalar ADMM eps=1e-9 on the first n_oracle "
              "elements of sim 0 (max_dev_x_vs_f64); f32 tight ADMM over "
              "the full batch kept as the secondary max_dev_x_vs_tight "
              "column")


def f64_oracle(data: QPData, n_oracle):
    """Independent f64 comparator: the numpy/scipy scalar ADMM at eps 1e-9
    on the first ``n_oracle`` batch elements, on the host in float64."""
    xs = []
    for i in range(n_oracle):
        sol = solve_box_qp_np(
            *(t[i].detach().cpu().double().numpy() for t in data),
            eps_abs=1e-9, eps_rel=1e-9, max_iters=100000)
        gate(sol["converged"], f"f64 oracle failed on element {i}")
        xs.append(sol["x"])
    return np.stack(xs)


def timed_solve(fn, args, n_reps, device):
    """x of ``fn(*args)`` (one warm-up call) and the median forward time
    over ``n_reps`` calls."""
    def call():
        with torch.no_grad():
            return fn(*args)
    x, _ = clock(call, device)
    return x, statistics.median(clock(call, device)[1]
                                for _ in range(n_reps))


def sweep_size(n_x, n_batch, tol, n_reps, n_oracle, device, data=None):
    device = torch.device(device)
    n_oracle = min(n_oracle, n_batch)
    data = data if data is not None else create_qp_data(
        n_x, n_batch, seed=0, dtype=torch.float32, device=device)
    G, h = data.with_G_h()
    gh = (data.Q, data.p, data.A, data.b, G, h)
    tight = BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6, max_iters=2000)
    with torch.no_grad():
        x_tight = solve_box_qp(*data, config=tight).x

    print(f"n={n_x}: solving {n_oracle} problems with the f64 numpy "
          f"oracle (eps 1e-9)...", flush=True)
    x64 = f64_oracle(data, n_oracle)
    dev_tight64 = float(np.max(np.abs(
        x_tight[:n_oracle].double().cpu().numpy() - x64)))
    print(f"n={n_x}: the f32 tight-ADMM comparator itself deviates "
          f"{dev_tight64:.2e} from f64", flush=True)

    def devs(x):
        return {
            "max_dev_x_vs_f64": float(np.max(np.abs(
                x[:n_oracle].double().cpu().numpy() - x64))),
            "max_dev_x_vs_tight": float((x - x_tight).abs().max()),
        }

    cells = []

    def record(label, refine, polish, fn, args):
        x, fwd_s = timed_solve(fn, args, n_reps, device)
        d = devs(x)
        cells.append({"solver": label, "n_x": n_x, "refine_steps": refine,
                      "polish": polish, **d, "fwd_s": fwd_s})
        print(f"n={n_x} {label} refine={refine} polish={polish}: "
              f"dev_f64={d['max_dev_x_vs_f64']:.2e} fwd={fwd_s:.4f}s",
              flush=True)

    for refine in (0, 1, 2):
        for polish in (False, True):
            cfg = OptNetConfig(tol=tol, max_iters=30, refine_steps=refine,
                               polish=polish)
            record("OptNet_IP", refine, polish,
                   lambda *a, cfg=cfg: solve_qp_optnet(*a, config=cfg).x, gh)
            record("BoxIP", refine, polish,
                   lambda *a, cfg=cfg: solve_box_qp_ip(*a, config=cfg).x,
                   tuple(data))
    # ADMM at the same working tolerance, with and without the OSQP-style
    # polish: the comparator for the IP cells and the measured cost of the
    # polish's extra factorization.
    for polish in (False, True):
        cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol, polish=polish)
        record("ADMM", 0, polish,
               lambda *a, cfg=cfg: solve_box_qp(*a, config=cfg).x,
               tuple(data))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[500, 1000])
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--n-reps", type=int, default=5)
    ap.add_argument("--n-oracle", type=int, default=8,
                    help="batch elements solved by the f64 numpy oracle")
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cells = []
    for n_x in args.sizes:
        cells.extend(sweep_size(n_x, args.n_batch, args.tol, args.n_reps,
                                args.n_oracle, device))
    write_json(args.out_dir, ARTIFACT, {
        "device": device_label(device), "torch": torch.__version__,
        "n_batch": args.n_batch, "tol": args.tol,
        "n_oracle": args.n_oracle, "comparator": COMPARATOR,
        "cells": cells})
    return cells


if __name__ == "__main__":
    main()
