"""Which elements the float32 polish of the port's interior points rejects,
and by which acceptance test, under the equality test read whole (|Ax - b|,
as the JAX package reads it) and beyond its rounding (``equality_excess``,
the port's): OptNet with the box as G = [-I; I] (condensed) and the box IP,
at Experiment 1's configuration (tol 1e-5, 30 iterations, polish).

    python tools/port_ip_polish_diagnosis.py [--device cuda] [--batch 128]
        [--n 1000] [--seed 0] [--pool-seed S --batches K]

Problems: the port's ``create_qp_data`` on the device, float32; with
``--pool-seed``, the first K batches that the benchmark's ``exp1`` family
(``qpbench/problems/exp1.py``) draws from that seed, as a training cell's
pool holds them.  Each polish round's point is kept by wrapping
``polish_rounds`` and held to the solvers' own test (``_polish.accepted``,
their thresholds); the IP's own iterate is the solve's without polish.  Per
solver it prints the iterations, how many elements each rule accepts
(round 2, else round 1, else the third round where the solver ran one,
else none), the largest |x - x_f64| of the solve as it stands (float64
optimum: ``qpbench/reference/boxqp_ref.py``), and for each element that a
rule rejects (``--details whole``, the default, or ``excess``): each
round's bound-row violation, equality residual (float32 and float64) and
its rounding allowance, the bound they are held to, the least multiplier,
and the float64 optimum's complementarity margin (``boxqp_ref.margin``).
Needs no JAX; on the card it takes
~1 min at the default size, on the CPU use a small batch.
"""

import argparse
import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import lqp_py_tpu_torch as T  # noqa: E402
from lqp_py_tpu_torch.models import _polish, box_ip, optnet  # noqa: E402
from lqp_py_tpu_torch.utils.generators import create_qp_data  # noqa: E402


@functools.lru_cache(maxsize=None)
def _reference():
    path = ROOT / "qpbench" / "reference" / "boxqp_ref.py"
    spec = importlib.util.spec_from_file_location("boxqp_ref", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["boxqp_ref"] = mod
    spec.loader.exec_module(mod)
    return mod


def _rounds(module):
    """Wrap ``module.polish_rounds`` to keep each round's elements and
    point: ``(k, result)``, ``k`` an index tensor or ``slice(None)``."""
    kept, real = [], module.polish_rounds

    def rounds(solve, *args):
        def kept_solve(act, k):
            kept.append((k, solve(act, k)))
            return kept[-1][1]
        return real(kept_solve, *args)
    module.polish_rounds = rounds
    return kept, lambda: setattr(module, "polish_rounds", real)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _rows(k, B):
    """Element e's row in a round on the elements ``k`` (None if absent)."""
    if isinstance(k, slice):
        return list(range(B))
    rows = [None] * B
    for i, e in enumerate(k.tolist()):
        rows[e] = i
    return rows


def diagnose(label, d, solve, ineq, lam_min, thr, thr_lam, module, sol64,
             details):
    """``ineq(x, k)``: the bound rows' violation of x, the point of the
    elements ``k``."""
    kept, restore = _rounds(module)
    try:
        sol = solve(True)
    finally:
        restore()
    x_ip = solve(False).x
    A, b = d.A, d.b
    B = x_ip.shape[0]
    every = slice(None)

    def eq_whole(x, k=every):
        return (_mv(A[k], x) - b[k]).abs().amax(-1)

    def eq_excess(x, k=every):
        return _polish.equality_excess(A[k], b[k], x)

    rules = {"whole": eq_whole, "excess": eq_excess}
    ok = {}
    for rule, eq in rules.items():
        viol_ip = torch.maximum(ineq(x_ip, every), eq(x_ip))
        ok[rule] = []
        for k, r in kept:
            # The solvers' test (``_polish.accepted``) with this rule's
            # equality part; False on elements the round did not solve.
            full = torch.zeros(B, dtype=torch.bool, device=x_ip.device)
            full[k] = _polish.accepted(
                torch.maximum(ineq(r.x, k), eq(r.x, k)), viol_ip[k], thr[k],
                lam_min(r), thr_lam[k])
            ok[rule].append(full)
    err = (sol.x.double() - sol64.x).abs().amax(-1)
    margin = _reference().margin(sol64)
    print(f"{label}: {sol.iterations} iterations, "
          f"{int(sol.converged.sum())}/{len(err)} converged; max|x - x_f64| "
          f"{err.max().item():.3e} ({int((err > 1e-4).sum())} elements "
          f"beyond 1e-4)")
    for rule, oks in ok.items():
        # The solvers' order of preference: round 2, round 1, round 3 (run
        # only where neither of the first two passed on some element).
        order = [1, 0] + list(range(2, len(oks)))
        left = torch.ones_like(oks[0])
        counts = []
        for k in order:
            counts.append(f"round {k + 1} {int((oks[k] & left).sum())}")
            left = left & ~oks[k]
        print(f"  rule '{rule}': accepted by {', '.join(counts)}; rejected "
              f"{int(left.sum())}")
    left = torch.ones_like(ok[details][0])
    for o in ok[details]:
        left = left & ~o
    rejected = torch.nonzero(left).flatten()
    for e in rejected.tolist():
        print(f"  element {e}: |x - x_f64| {err[e].item():.3e}, margin "
              f"{margin[e].item():.3e}; IP equality "
              f"{eq_whole(x_ip)[e].item():.3e}, bound rows "
              f"{ineq(x_ip, every)[e].item():.3e}, threshold "
              f"{thr[e].item():.3e}")
        for n, (k, r) in enumerate(kept):
            i = _rows(k, B)[e]
            if i is None:
                continue
            x, one = r.x[i:i + 1], slice(e, e + 1)
            r64 = (_mv(A[one].double(), x.double())
                   - b[one].double()).abs().amax().item()
            allow = (torch.finfo(x.dtype).eps
                     * _mv(A[one].abs(), x.abs())).amax().item()
            print(f"    round {n + 1}: bound rows "
                  f"{ineq(x, one).item():.3e}, equality "
                  f"{eq_whole(x, one).item():.3e} (float64 {r64:.3e}, "
                  f"allowance {allow:.3e}), least multiplier "
                  f"{lam_min(r)[i].item():.3e} against "
                  f"{-thr_lam[e].item():.3e}; accepted whole "
                  f"{bool(ok['whole'][n][e])}, excess "
                  f"{bool(ok['excess'][n][e])}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool-seed", type=int)
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--details", choices=("whole", "excess"),
                    default="whole")
    ns = ap.parse_args()
    if ns.pool_seed is None:
        batches = [create_qp_data(ns.n, ns.batch, seed=ns.seed,
                                  dtype=torch.float32, device=ns.device)]
    else:
        from qpbench import data
        spec = {"generator": "exp1", "n_x": ns.n, "n_samples": 2 * ns.n,
                "n_eq": 1, "box": [1.0, 2.0], "dtype": "float32"}
        gen = data.generator(ns.pool_seed, ns.device)
        batches = [data.make(spec, ns.batch, gen, ns.device)
                   for _ in range(ns.batches)]
    for k, d in enumerate(batches):
        print(f"batch {k}")
        _batch(d, ns.details)


def _batch(d, details):
    cfg = T.OptNetConfig(tol=1e-5, max_iters=30, symmetrize=False)
    sol64 = _reference().solve(*(t.double() for t in d[:6]))
    n = d.p.shape[-1]
    eye = torch.eye(n, dtype=d.Q.dtype, device=d.Q.device)
    G = torch.cat([-eye, eye]).expand(d.p.shape[0], 2 * n, n)
    h = torch.cat([-d.lb, d.ub], dim=-1)
    # The thresholds as the solvers set them (models/_polish.py).
    thr = _polish.acceptance_threshold(cfg.tol, h.abs().amax(-1))
    diagnose(
        "OptNet condensed", d,
        lambda pol: T.solve_qp_optnet(
            d.Q, d.p, d.A, d.b, G, h,
            config=dataclasses.replace(cfg, polish=pol)),
        lambda x, k: (_mv(G[k], x) - h[k]).clamp(min=0.0).amax(-1),
        lambda r: r.lam.amin(-1), thr,
        _polish.gen_lam_threshold(thr, torch.float32), optnet, sol64,
        details)
    thr_box = _polish.acceptance_threshold(cfg.tol, torch.maximum(
        d.lb.abs().amax(-1), d.ub.abs().amax(-1)))
    diagnose(
        "box IP", d,
        lambda pol: T.solve_box_qp_ip(
            *d[:6], config=dataclasses.replace(cfg, polish=pol)),
        lambda x, k: torch.maximum(d.lb[k] - x, x - d.ub[k]).amax(-1),
        lambda r: torch.minimum(r.lam_lo, r.lam_hi).amin(-1), thr_box,
        thr_box, box_ip, sol64, details)


if __name__ == "__main__":
    main()
