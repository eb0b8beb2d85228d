"""Experiment 1: forward+backward runtime sweep across problem sizes.

The port's counterpart of ``experiments/experiment_1.py``, on the card.
The reference benchmark protocol (batch=128, tol 1e-5, median over n_sims
of fwd+bwd wall-clock) across the solver family:

- ADMM fixed-point / KKT / unrolled backward (the three reference modes)
- the OptNet-style interior point (the box as general inequalities) and
  the box-structured interior point
- GenQP operator splitting (the SCS-capability solver)
- the native C++ CPU ADMM (the sequential baseline, like the reference's
  SCS), built from ``native/lqp_native.cpp`` by ``cpu/native.py``

Each timed call ends in ``torch.cuda.synchronize()``; data generation and
host-to-device copies stay outside the timed window.  ``device_total``
runs K distinct fwd+bwd solves back to back, synchronizes once and reports
total / K (no CUDA graph, no ``torch.compile``).  Every timed mode is gated
against a tight-tolerance ADMM reference on sim 0.

Writes ``exp1_results_torch.json`` into ``--out-dir`` (merged with the
sizes already there for the same device, tolerance and batch) and
``exp1_times_torch.png`` where matplotlib is importable.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_1 \\
          --sizes 10 50 100 250 500 1000 [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import torch

from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, OptNetConfig, boxqp,
                              boxqp_ip, qp_gen, qp_optnet, solve_box_qp,
                              solve_box_qp_ip, solve_box_qp_unrolled,
                              solve_qp_gen, solve_qp_optnet)
from lqp_py_tpu_torch.cpu import native
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, gate,
                                                  memory_mark, peak_above,
                                                  read_json, write_json)
from lqp_py_tpu_torch.experiments.plotting import plot_profile_bars
from lqp_py_tpu_torch.utils.generators import QPData, create_qp_data
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

ARTIFACT = "exp1_results_torch.json"
CHART = "exp1_times_torch.png"

# Per-mode deviation gate vs the tight-tolerance ADMM reference on sim 0
# (f32; the IP x-accuracy floor at dz=1000 is ~6e-3 — PARITY.md #6 — so
# 2e-2 catches a mis-tuned unroll_iters / max_iters drift without
# flagging the known float32 floor).
DEV_GATE = 2e-2

TIGHT = BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6, max_iters=2000)

DEVICE_TOTAL_NOTE = (
    "marginal s/solve over K distinct fwd+bwd solves (Q + |d| I, p + d) "
    "run back to back and synchronized once (K = chain_length(n_x)); no "
    "CUDA graph, no torch.compile")


def box_modes(tol):
    """The three reference ADMM modes.  symmetrize=False is protocol-fair:
    the generators emit exactly symmetric Q and the reference performs no
    symmetrization pass (solve_box_qp_admm_torch.py:161-215)."""
    return {
        "ADMM_FP": BoxQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False,
                               backward="fixed_point"),
        "ADMM_KKT": BoxQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False,
                                backward="kkt"),
        # The tuned solver converges in ~21-31 iterations on this family;
        # 60 static unrolled iterations is a ~2x margin over observed
        # convergence (the reference's dynamic unroll runs ~61 iterations
        # at ITS rho defaults — same relative margin).
        "ADMM_Unroll": BoxQPConfig(eps_abs=tol, eps_rel=tol, unroll=True,
                                   symmetrize=False, unroll_iters=60,
                                   adaptive_rho=False),
    }


def gen_config(tol):
    return GenQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False)


def ip_config(tol):
    return OptNetConfig(tol=tol, max_iters=30, symmetrize=False)


def box_args(data: QPData):
    return tuple(data)


def gh_args(data: QPData):
    """The same QP with the box written as G = [-I; I], h = [-lb; ub]."""
    G, h = data.with_G_h()
    return (data.Q, data.p, data.A, data.b, G, h)


def seeded_data(n_x, n_batch, device):
    """``data_for_seed(seed)``: fresh problems per sim, as the reference
    draws them (the port's generator stream, f32, on ``device``)."""
    def data_for_seed(seed):
        return create_qp_data(n_x, n_batch, seed=seed, dtype=torch.float32,
                              device=device)
    return data_for_seed


def layer_calls(tol, include_ip=True):
    """``{column: (layer call, argument maker)}`` of the timed columns."""
    calls = {name: ((lambda Q, p, A, b, lb, ub, cfg=cfg: boxqp(
        Q, p, A, b, lb, ub, config=cfg)), box_args)
        for name, cfg in box_modes(tol).items()}
    gen_cfg = gen_config(tol)
    calls["GenQP"] = ((lambda Q, p, A, b, G, h: qp_gen(
        Q, p, A, b, G, h, config=gen_cfg)), gh_args)
    if include_ip:
        ip_cfg = ip_config(tol)
        calls["OptNet_IP"] = ((lambda Q, p, A, b, G, h: qp_optnet(
            Q, p, A, b, G, h, config=ip_cfg)), gh_args)
        calls["BoxIP"] = ((lambda Q, p, A, b, lb, ub: boxqp_ip(
            Q, p, A, b, lb, ub, config=ip_cfg)), box_args)
    return calls


def fwd_fn(call):
    """The layer's forward alone: sum(x), no gradient."""
    def fwd(*args):
        with torch.no_grad():
            return call(*args).sum()
    return fwd


def grad_fn(call):
    """Forward+backward: sum(x) and its gradients with respect to Q and p
    (``torch.autograd.grad``)."""
    def fwd_bwd(Q, p, *rest):
        Q = Q.detach().requires_grad_(True)
        p = p.detach().requires_grad_(True)
        loss = call(Q, p, *rest).sum()
        gQ, gp = torch.autograd.grad(loss, (Q, p))
        return loss.detach(), gQ, gp
    return fwd_bwd


def time_split(fwd, tot, data_for_seed, n_sims, device):
    """Reference protocol (the reference's experiments/experiment_1.py:55-101):
    fresh problem data per sim (seed=i), forward and forward+backward timed
    separately, median over sims with ~95% error bars (1.96 std/sqrt(n)).
    ``data_for_seed(i)`` returns the call's arguments.  Backward = total -
    forward (an isolated backward timing would re-run the forward)."""
    args0 = data_for_seed(0)
    clock(lambda: fwd(*args0), device)          # warm-up
    clock(lambda: tot(*args0), device)
    del args0
    fwd_ts, tot_ts = [], []
    for i in range(n_sims):
        args = data_for_seed(i)     # clock waits for its copies first
        fwd_ts.append(clock(lambda: fwd(*args), device)[1])
        tot_ts.append(clock(lambda: tot(*args), device)[1])
        del args

    def ci(ts):
        return 1.96 * statistics.pstdev(ts) / len(ts) ** 0.5

    med_f, med_t = statistics.median(fwd_ts), statistics.median(tot_ts)
    # bwd is a DERIVED quantity (total - fwd medians): when the true
    # backward cost is below the timing noise the difference can come out
    # negative, which is meaningless as a duration — clamp at 0; `total`
    # remains the measured number.
    return {"fwd": med_f, "bwd": max(med_t - med_f, 0.0), "total": med_t,
            "fwd_ci": ci(fwd_ts), "total_ci": ci(tot_ts)}


def device_limited(call, args, K, device, n_reps=3):
    """Per-solve fwd+bwd time over K DISTINCT solves run back to back
    (Q + |d| I and p + d for K draws of d), synchronized once: total / K,
    median of ``n_reps`` chains after one warm-up chain.  Distinct Q and p
    per solve, so no factorization is reused."""
    Q, p, rest = args[0], args[1], args[2:]
    g = torch.Generator(device=p.device).manual_seed(7)
    dps = torch.randn((K,) + tuple(p.shape), generator=g, dtype=p.dtype,
                      device=p.device) * 0.01
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)

    def chained():
        acc = Q.new_zeros(())
        for d in dps:
            Qk = (Q + d[0, 0].abs() * eye).requires_grad_(True)
            pk = (p + d).requires_grad_(True)
            loss = call(Qk, pk, *rest).sum()
            gQ, gp = torch.autograd.grad(loss, (Qk, pk))
            acc = acc + loss.detach() + gQ.abs().sum() + gp.abs().sum()
            del Qk, pk, loss, gQ, gp
        return acc

    clock(chained, device)
    return statistics.median(clock(chained, device)[1] / K
                             for _ in range(n_reps))


def chain_length(n_x):
    """Longer chains at small sizes, where per-solve device time is far
    below the per-call overhead being amortized."""
    return 64 if n_x <= 50 else 16 if n_x <= 100 else 8 if n_x <= 250 else 4


def quality_gate(name, x_mode, x_tight, converged=None, iterations=None):
    """Convergence/accuracy stats for a timed mode (sim 0): nothing in the
    timed path asserts the solves are good, so a config/generator drift
    could silently benchmark non-converged solves.  Returns the record and
    raises if the mode regressed."""
    dev = float((x_mode.detach().double()
                 - x_tight.detach().double()).abs().max())
    rec = {"max_dev_x_vs_tight": dev}
    if converged is not None:
        rec["n_converged"] = int(converged.sum())
        rec["n_problems"] = int(converged.shape[0])
        gate(rec["n_converged"] == rec["n_problems"],
             f"{name}: only {rec['n_converged']}/{rec['n_problems']} "
             f"problems converged in the timed configuration")
    if iterations is not None:
        rec["iterations"] = int(iterations)
    gate(dev < DEV_GATE,
         f"{name}: max |x - x_tight| = {dev:.3e} exceeds the {DEV_GATE} "
         f"gate — the timed configuration is returning inaccurate solves")
    return rec


def tight_reference(data: QPData):
    """x of the tight-tolerance ADMM solve: the accuracy comparator for
    every timed mode (the G = [-I; I] form is the same QP)."""
    with torch.no_grad():
        return solve_box_qp(*box_args(data), config=TIGHT).x


def column_solutions(data: QPData, tol, include_ip=True):
    """The solves the gates read, on sim 0's data: ``{name: (x, converged,
    iterations)}`` for 'ADMM' (the while-loop solve that FP and KKT share),
    'ADMM_Unroll' (x only: the unrolled scan has no converged flag),
    'GenQP' and, with ``include_ip``, 'OptNet_IP' and 'BoxIP'."""
    modes = box_modes(tol)
    box, gh = box_args(data), gh_args(data)
    out = {}
    with torch.no_grad():
        s = solve_box_qp(*box, config=modes["ADMM_FP"])
        out["ADMM"] = (s.x, s.converged, s.iterations)
        out["ADMM_Unroll"] = (solve_box_qp_unrolled(
            *box, config=modes["ADMM_Unroll"]), None, None)
        s = solve_qp_gen(*gh, config=gen_config(tol))
        out["GenQP"] = (s.x, s.converged, s.iterations)
        if include_ip:
            s = solve_qp_optnet(*gh, config=ip_config(tol))
            out["OptNet_IP"] = (s.x, s.converged, s.iterations)
            s = solve_box_qp_ip(*box, config=ip_config(tol))
            out["BoxIP"] = (s.x, s.converged, s.iterations)
    return out


def native_column(data: QPData, tol):
    """The native C++ CPU forward (sequential over the batch, float64),
    timed on the host; the problems are copied off the card first."""
    args = [t.detach().cpu().double().numpy() for t in box_args(data)]
    t0 = time.perf_counter()
    native.solve_box_qp_native(*args, eps_abs=tol, eps_rel=tol)
    return {"fwd": time.perf_counter() - t0}


def run_size(n_x, n_batch, tol, n_sims, include_ip, device,
             data_for_seed=None, include_native=True):
    """Every column at one size: ``{column: record}``.  ``data_for_seed``
    (default: ``seeded_data``) gives sim i's ``QPData``."""
    device = torch.device(device)
    data_for_seed = data_for_seed or seeded_data(n_x, n_batch, device)
    data0 = data_for_seed(0)
    K = chain_length(n_x)
    x_tight = tight_reference(data0)
    out = {}
    for name, (call, make_args) in layer_calls(tol, include_ip).items():
        mark = memory_mark(device)
        out[name] = time_split(fwd_fn(call), grad_fn(call),
                               lambda s: make_args(data_for_seed(s)),
                               n_sims, device)
        out[name]["device_total"] = device_limited(call, make_args(data0),
                                                   K, device)
        if mark is not None:
            # The column's peak above what was held before it (sim 0's
            # data and the tight reference among that).
            out[name]["peak_mem_bytes"] = peak_above(device, mark)

    sols = column_solutions(data0, tol, include_ip)
    # FP and KKT share the forward solve; only the backward differs.
    q = quality_gate("ADMM", x_tight=x_tight, x_mode=sols["ADMM"][0],
                     converged=sols["ADMM"][1], iterations=sols["ADMM"][2])
    out["ADMM_FP"].update(q)
    out["ADMM_KKT"].update(q)
    # The unrolled scan has no converged flag: the deviation gate is what
    # catches an undersized unroll_iters.
    out["ADMM_Unroll"].update(quality_gate("ADMM_Unroll",
                                           sols["ADMM_Unroll"][0], x_tight))
    for name in ("GenQP", "OptNet_IP", "BoxIP"):
        if name in sols:
            out[name].update(quality_gate(name, x_tight=x_tight,
                                          x_mode=sols[name][0],
                                          converged=sols[name][1],
                                          iterations=sols[name][2]))
    if include_native and native.available():
        out["Native_CPU_fwd"] = native_column(data0, tol)
    return out


def merge_results(out_dir, results, device, tol, n_batch):
    """The new sizes over the artifact's old ones, where the old file was
    written on the same device (name and power limit), tolerance and
    batch, so the sweep can be (re)run size by size."""
    old = read_json(Path(out_dir) / ARTIFACT) or {}
    merged = dict(results)
    if (old.get("device") == device and old.get("tol") == tol
            and old.get("n_batch") == n_batch):
        for k, v in old.get("results", {}).items():
            merged.setdefault(int(k), v)
    return {int(k): v for k, v in sorted(merged.items(),
                                         key=lambda kv: int(kv[0]))}


def save(out_dir, results, device, n_batch, tol, n_sims):
    """Merge ``results`` ({n_x: {column: record}}) into the artifact in
    ``out_dir``, write it and its chart; returns the merged results."""
    label = device_label(torch.device(device))
    results = merge_results(out_dir, results, label, tol, n_batch)
    write_json(out_dir, ARTIFACT, {
        "device": label, "torch": torch.__version__, "n_batch": n_batch,
        "tol": tol, "n_sims": n_sims,
        "device_total_note": DEVICE_TOTAL_NOTE, "results": results})
    plot(results, out_dir)
    return results


def plot(results, out_dir):
    totals = {s: {k: v.get("total", v["fwd"]) for k, v in r.items()}
              for s, r in results.items()}
    errors = {s: {k: v.get("total_ci", 0.0) for k, v in r.items()}
              for s, r in results.items()}
    path = Path(out_dir) / CHART
    if plot_profile_bars(totals, path, errors=errors):
        print(f"wrote {path}")
    else:
        print("(no chart: matplotlib is not importable)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[10, 50, 100, 250, 500])
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--n-sims", type=int, default=5)
    ap.add_argument("--max-ip-size", type=int, default=10_000,
                    help="skip the interior-point solvers above this size")
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    for n_x in args.sizes:
        r = run_size(n_x, args.n_batch, args.tol, args.n_sims,
                     include_ip=n_x <= args.max_ip_size, device=device)
        results[n_x] = r
        print(f"n_x={n_x}: " + "  ".join(
            f"{k}={v.get('total', v['fwd']):.4f}s"
            f"(f{v['fwd']:.4f}/b{v.get('bwd', 0):.4f})"
            for k, v in r.items()), flush=True)

    save(args.out_dir, results, device, args.n_batch, args.tol, args.n_sims)
    return results


if __name__ == "__main__":
    main()
