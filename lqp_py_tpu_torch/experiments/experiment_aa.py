"""Anderson-acceleration ablation: iterations (and wall clock) vs window.

The port's counterpart of ``experiments/experiment_aa.py``.  Sweeps the
safeguarded-AA window over both solvers (box ADMM, GenQP splitting) and
both problem families (random-SPD 'create', ill-conditioned sparse
'hard'), f32, recording iteration counts, convergence, the forward wall
clock and the solution's largest deviation from the plain (window 0) run.

Writes ``exp_aa_results_torch.json`` into ``--out-dir``.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_aa \\
          [--sizes 50 100 250] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import statistics

import torch

from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, solve_box_qp,
                              solve_qp_gen)
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, write_json)
from lqp_py_tpu_torch.utils.generators import create_qp_data, generate_hard_qp
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

ARTIFACT = "exp_aa_results_torch.json"


def family_data(family, n_x, n_batch, device):
    gen = generate_hard_qp if family == "hard" else create_qp_data
    return gen(n_x, n_batch, seed=0, dtype=torch.float32, device=device)


def _timed(f, *args, n_sims, device):
    clock(lambda: f(*args), device)
    return statistics.median(clock(lambda: f(*args), device)[1]
                             for _ in range(n_sims))


def run_cell(family, n_x, n_batch, tol, windows, n_sims, device, data=None):
    """``{box_aa<m>, gen_aa<m>: {iters, n_converged, time_s[,
    max_dev_vs_plain]}}`` for m in 0 and ``windows``.  ``data``: the
    family's ``QPData`` (default: the port's generator, seed 0)."""
    device = torch.device(device)
    data = data if data is not None else family_data(family, n_x, n_batch,
                                                     device)
    box = tuple(data)
    G, h = data.with_G_h()
    gh = (data.Q, data.p, data.A, data.b, G, h)
    out = {}
    plain_x = {}
    for m in [0] + list(windows):
        for key, solve, args, cfg in (
                ("box", solve_box_qp, box,
                 BoxQPConfig(eps_abs=tol, eps_rel=tol, acceleration=m)),
                ("gen", solve_qp_gen, gh,
                 GenQPConfig(eps_abs=tol, eps_rel=tol, acceleration=m))):
            def f(*a, solve=solve, cfg=cfg):
                with torch.no_grad():
                    return solve(*a, config=cfg)
            sol = f(*args)
            cell = {"iters": int(sol.iterations),
                    "n_converged": int(sol.converged.sum()),
                    "time_s": _timed(f, *args, n_sims=n_sims,
                                     device=device)}
            if m == 0:
                plain_x[key] = sol.x
            else:
                cell["max_dev_vs_plain"] = float(
                    (sol.x - plain_x[key]).abs().max())
            out[f"{key}_aa{m}"] = cell
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[50, 100, 250])
    ap.add_argument("--n-batch", type=int, default=64)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--windows", type=int, nargs="*", default=[10, 20])
    ap.add_argument("--n-sims", type=int, default=5)
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    for family in ("hard", "create"):
        for n_x in args.sizes:
            key = f"{family}_n{n_x}"
            results[key] = run_cell(family, n_x, args.n_batch, args.tol,
                                    args.windows, args.n_sims, device)
            print(key + ": " + "  ".join(
                f"{k}={v['iters']}it/{v['time_s']:.3f}s"
                for k, v in results[key].items()), flush=True)

    write_json(args.out_dir, ARTIFACT, {
        "device": device_label(device), "torch": torch.__version__,
        "n_batch": args.n_batch, "tol": args.tol, "n_sims": args.n_sims,
        "results": results})
    return results


if __name__ == "__main__":
    main()
