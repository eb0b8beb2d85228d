"""Regenerate the port's measured-numbers block in README.md from the
port's ``*_torch.json`` artifacts.

The port's counterpart of ``experiments/render_readme.py``.  Every number
the block quotes comes from an artifact field; an artifact that is not
there renders as "not captured", never as a number.  The block sits
between its own markers inside README's "PyTorch / H100 port" section;
the JAX package's block (``AUTOGEN NUMBERS``) is never touched.

Run:  python -m lqp_py_tpu_torch.experiments.render_readme \\
          [--readme README.md] [--artifacts-dir .]
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

from lqp_py_tpu_torch.experiments._common import read_json

BEGIN = ("<!-- BEGIN AUTOGEN TORCH NUMBERS "
         "(python -m lqp_py_tpu_torch.experiments.render_readme) -->")
END = "<!-- END AUTOGEN TORCH NUMBERS -->"

# The reference's ADMM-FP/KKT/Unroll/OptNet/SCS totals (s) read off its
# published CPU charts (BASELINE.md; images/exp_1_n_*.png).  BoxIP shares
# OptNet's comparator (the reference's only IP, on the same problems).
REF = {
    10:   {"ADMM_FP": 0.025, "ADMM_KKT": 0.038, "ADMM_Unroll": 0.044,
           "GenQP": 0.13, "OptNet_IP": 0.011, "BoxIP": 0.011},
    50:   {"ADMM_FP": 0.027, "ADMM_KKT": 0.14, "ADMM_Unroll": 0.050,
           "GenQP": 0.28, "OptNet_IP": 0.20, "BoxIP": 0.20},
    100:  {"ADMM_FP": 0.068, "ADMM_KKT": 0.18, "ADMM_Unroll": 0.22,
           "GenQP": 0.61, "OptNet_IP": 0.42, "BoxIP": 0.42},
    250:  {"ADMM_FP": 0.26, "ADMM_KKT": 0.89, "ADMM_Unroll": 0.88,
           "GenQP": 3.2, "OptNet_IP": 3.6, "BoxIP": 3.6},
    500:  {"ADMM_FP": 0.75, "ADMM_KKT": 2.7, "ADMM_Unroll": 2.8,
           "GenQP": 13.1, "OptNet_IP": 13.1, "BoxIP": 13.1},
    1000: {"ADMM_FP": 2.6, "ADMM_KKT": 9.5, "ADMM_Unroll": 9.5,
           "GenQP": 80.0, "OptNet_IP": 70.0, "BoxIP": 70.0},
}
REF_EXP2_S = 27.0   # images/exp_2_n_500.png, ADMM-FP cumulative train time

COLS = ["ADMM_FP", "ADMM_KKT", "ADMM_Unroll", "GenQP", "OptNet_IP", "BoxIP"]
NAMES = {"ADMM_FP": "ADMM FP", "ADMM_KKT": "ADMM KKT",
         "ADMM_Unroll": "ADMM Unroll", "GenQP": "GenQP",
         "OptNet_IP": "OptNet IP", "BoxIP": "Box IP"}
REFNAMES = {"GenQP": "ref SCS", "OptNet_IP": "ref OptNet",
            "BoxIP": "ref OptNet"}


def _fmt(v, digits=3):
    return f"{v:.{digits}f}".rstrip("0").rstrip(".") if v is not None else "—"


def _ms(v):
    return f"{v * 1e3:.1f} ms"


def _not_captured(what, artifact):
    return [f"{what}: not captured (no `{artifact}`).", ""]


def _exp1(exp1):
    if not exp1:
        return _not_captured("Experiment 1", "exp1_results_torch.json")
    results = {int(k): v for k, v in exp1.get("results", {}).items()}
    out = [f"Experiment 1 on one {exp1['device']} (torch "
           f"{exp1.get('torch', '?')}; batch={exp1['n_batch']}, tol "
           f"{exp1['tol']:g}, fresh data per sim, median of "
           f"forward+backward over {exp1['n_sims']} sims, each call ending "
           f"in `torch.cuda.synchronize()`; `exp1_results_torch.json`), "
           f"total s beside the reference's published CPU numbers:", ""]
    header, rule = "| dz |", "|----|"
    for c in COLS:
        header += f" {NAMES[c]} | ({REFNAMES.get(c, 'ref')}) |"
        rule += "---|---|"
    out += [header + " native CPU fwd |", rule + "---|"]
    for dz in sorted(results):
        row = f"| {dz} |"
        for c in COLS:
            tot = (results[dz].get(c) or {}).get("total")
            ref = REF.get(dz, {}).get(c)
            row += (f" {_fmt(tot, 4)} s |" if tot is not None else " — |")
            row += f" {_fmt(ref, 2) if ref else '—'} |"
        nat = (results[dz].get("Native_CPU_fwd") or {}).get("fwd")
        out.append(row + (f" {_fmt(nat, 4)} s |" if nat is not None
                          else " — |"))
    out.append("")
    if any("device_total" in (results[dz].get(c) or {})
           for dz in results for c in COLS):
        out += ["Per solve with K distinct fwd+bwd solves run back to back "
                "and synchronized once (`device_total`, s; speedup against "
                "the same reference numbers):", ""]
        header2, rule2 = "| dz |", "|----|"
        for c in COLS:
            header2 += f" {NAMES[c]} | x |"
            rule2 += "---|---|"
        out += [header2, rule2]
        for dz in sorted(results):
            row = f"| {dz} |"
            for c in COLS:
                dt = (results[dz].get(c) or {}).get("device_total")
                ref = REF.get(dz, {}).get(c)
                row += f" {_fmt(dt, 4)} s |" if dt is not None else " — |"
                row += (f" {ref / dt:.2g}x |" if dt and ref else " — |")
            out.append(row)
        out.append("")
    return out


def _exp2(exp2):
    if not exp2:
        return _not_captured("Experiment 2", "exp2_results_torch.json")
    c = exp2["config"]
    return [f"Experiment 2 on one {exp2['device']} (dz={c['n_x']}, "
            f"minibatch {c['mini_batch']} of {c['n_batch']}, "
            f"{c['epochs']} epochs; `exp2_results_torch.json`): "
            f"{_fmt(exp2['total_time_s'])} s step by step from Python, "
            f"{_fmt(exp2['fused_total_s'])} s for the whole horizon through "
            f"`make_train_scan` (the reference: ~{REF_EXP2_S:.0f} s on its "
            f"CPU); the two trajectories agree to "
            f"{exp2['fused_vs_loop_loss_dev']:.1e}, loss "
            f"{exp2['losses'][0]:.4f} -> {exp2['losses'][-1]:.4f}.", ""]


def _serving(serving):
    if not serving:
        return _not_captured("Serving", "exp_serving_results_torch.json")
    med_c = statistics.median(serving["cold"])
    med_w = statistics.median(serving["warm"])
    return [f"Serving on one {serving['device']} (dz={serving['n_x']}, "
            f"batch={serving['n_batch']}, p drifting "
            f"{serving['drift']:g} a step, {len(serving['cold'])} steps; "
            f"`exp_serving_results_torch.json`): a cold direct solve "
            f"{_ms(med_c)} (median, "
            f"{statistics.median(serving['cold_iters'])} iterations), a "
            f"prepared warm-started one {_ms(med_w)} "
            f"({statistics.median(serving['warm_iters'])} iterations); the "
            f"whole horizon back to back {_ms(serving['fused_per_solve'])} "
            f"per solve, GenQP's "
            f"{_ms(serving['genqp_fused_per_solve'])}.", ""]


def _straggler(strag):
    if not strag or not strag.get("results"):
        return _not_captured("Straggler", "exp_straggler_results_torch.json")
    cells = {int(k): v for k, v in strag["results"].items()}
    parts = [f"dz={n}: lock-step {_ms(c['xla_step']['median_s'])}, "
             f"early-exit {_ms(c['pallas_step']['median_s'])} "
             f"({c['pallas_speedup']:.2f}x; {c['xla_step']['iterations']} "
             f"iterations, {c['xla_step']['n_converged']}/"
             f"{c['n_batch']} converged)" for n, c in sorted(cells.items())]
    top = cells[max(cells)]
    return [f"Straggler serving on one {top['device']} "
            f"({top['n_hard']} hard among {top['n_batch']}; "
            f"`exp_straggler_results_torch.json`): " + "; ".join(parts)
            + ".", ""]


def _paper(paper):
    if not paper or not paper.get("results"):
        return _not_captured("Tolerance sweep",
                             "exp1_paper_results_torch.json")
    pr = paper["results"]
    digs = sorted({int(k.rsplit("_", 1)[1]) for k in pr})
    out = [f"Tolerance sweep on one {paper['protocol']['device']} "
           f"(dz={paper['protocol']['n_x']}, total fwd+bwd s; "
           f"`exp1_paper_results_torch.json`):", "",
           "| solver | " + " | ".join(f"1e-{d}" for d in digs) + " |",
           "|---|" + "---|" * len(digs)]
    for fam in ("ADMM_FP", "ADMM_KKT", "ADMM_Unroll", "OptNet", "GenQP"):
        out.append(f"| {fam} |" + "".join(
            f" {_fmt((pr.get(f'{fam}_{d}') or {}).get('total'), 4)} |"
            for d in digs))
    return out + [""]


def _hard(hard):
    if not hard:
        return _not_captured("Hard set", "exp1_hard_results_torch.json")
    res = {int(k): v for k, v in hard["results"].items()}
    parts = [f"dz={n}: ADMM FP {_fmt(r['ADMM_FP'], 4)} s ({r['_iters']} "
             f"iterations, {r['_n_converged']} converged), without adaptive "
             f"rho {r['_noadapt_iters']} iterations, Anderson 10 "
             f"{r['_aa10_iters']}, box IP {r['_BoxIP_iters']}"
             for n, r in sorted(res.items())]
    return [f"Hard set on one {hard['device']} (batch={hard['n_batch']}; "
            f"`exp1_hard_results_torch.json`): " + "; ".join(parts) + ".",
            ""]


def _aa(aa):
    if not aa:
        return _not_captured("Anderson acceleration",
                             "exp_aa_results_torch.json")
    parts = []
    for cell_name, cell in aa["results"].items():
        for solver in ("box", "gen"):
            base = cell[f"{solver}_aa0"]["iters"]
            best = min((v["iters"], k) for k, v in cell.items()
                       if k.startswith(f"{solver}_aa"))
            parts.append(f"{cell_name} {solver} {base}→{best[0]} "
                         f"({best[1].split('aa')[-1]})")
    return [f"Anderson acceleration on one {aa['device']} (iterations, "
            f"plain → best window; `exp_aa_results_torch.json`): "
            + "; ".join(parts) + ".", ""]


def _ip_accuracy(ipacc):
    if not ipacc or not ipacc.get("cells"):
        return _not_captured("Interior-point accuracy",
                             "ip_accuracy_results_torch.json")
    mx = max(c["n_x"] for c in ipacc["cells"])
    out = [f"Interior-point accuracy on one {ipacc['device']} at dz={mx} "
           f"(max |x − x_f64| against the numpy f64 oracle / max |x − "
           f"x_tight|, forward s; `ip_accuracy_results_torch.json`):", "",
           "| solver | refine_steps | polish | f64 / tight | fwd |",
           "|---|---|---|---|---|"]
    for c in ipacc["cells"]:
        if c["n_x"] == mx:
            out.append(f"| {c['solver']} | {c['refine_steps']} | "
                       f"{'on' if c['polish'] else 'off'} | "
                       f"{c['max_dev_x_vs_f64']:.1e} / "
                       f"{c['max_dev_x_vs_tight']:.1e} | "
                       f"{_fmt(c['fwd_s'], 4)} s |")
    return out + [""]


def render(artifacts_dir=".") -> str:
    d = Path(artifacts_dir)

    def load(name):
        return read_json(d / name)

    out = [BEGIN, ""]
    out += _exp1(load("exp1_results_torch.json"))
    out += _exp2(load("exp2_results_torch.json"))
    out += _serving(load("exp_serving_results_torch.json"))
    out += _straggler(load("exp_straggler_results_torch.json"))
    out += _paper(load("exp1_paper_results_torch.json"))
    out += _hard(load("exp1_hard_results_torch.json"))
    out += _aa(load("exp_aa_results_torch.json"))
    out += _ip_accuracy(load("ip_accuracy_results_torch.json"))
    out += ["Regenerate with `python -m "
            "lqp_py_tpu_torch.experiments.render_readme` after the drivers "
            "(`python -m lqp_py_tpu_torch.experiments.<name>`) have written "
            "their `*_torch.json` artifacts.", "", END]
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readme", default="README.md")
    ap.add_argument("--artifacts-dir", default=".")
    args = ap.parse_args(argv)
    readme = Path(args.readme).read_text()
    if BEGIN not in readme or END not in readme:
        print(f"{args.readme} is missing the port's AUTOGEN TORCH markers",
              file=sys.stderr)
        sys.exit(1)
    head, rest = readme.split(BEGIN, 1)
    _, tail = rest.split(END, 1)
    Path(args.readme).write_text(head + render(args.artifacts_dir) + tail)
    print(f"{args.readme}: the port's numbers block regenerated from the "
          f"artifacts in {args.artifacts_dir}")


if __name__ == "__main__":
    main()
