"""Experiment 2 (paper variant): publication-format charts for the
end-to-end learning benchmark.

The port's counterpart of ``experiments/experiment_2_paper.py`` (after the
reference's ``experiments/experiment_2_paper.py``, which re-runs
experiment 2 and renders its two paper figures at lines 103-126).  Here the
benchmark is ``experiment_2``, which writes ``exp2_results_torch.json``;
this renders the paper figures from that artifact — the cumulative
training time (per-step loop and whole horizon, beside the reference's
published CPU numbers) and the loss curve — as
``exp2_paper_time_dz_<n>_torch.(pdf|png)`` and
``exp2_paper_conv_dz_<n>_torch.(pdf|png)``.  ``--run`` runs the port's
``experiment_2`` first.  Without matplotlib no chart is written, and that
is not an error.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_2_paper \\
          [--run] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from lqp_py_tpu_torch.experiments import experiment_2
from lqp_py_tpu_torch.experiments._common import add_common_args
from lqp_py_tpu_torch.experiments.plotting import pyplot

# The reference's published CPU training times (images/exp_2_n_500.png).
REF_CPU_S = {"reference CPU (ADMM)": 27.0, "reference CPU (OptNet)": 365.0}


def render(results_path, out_dir="."):
    """Writes the two figures; returns their paths ([] without
    matplotlib)."""
    plt = pyplot()
    if plt is None:
        print("(no chart: matplotlib is not importable)")
        return []
    res = json.loads(Path(results_path).read_text())
    n_x = res["config"]["n_x"]
    losses = np.asarray(res["losses"], float)
    epochs = np.arange(len(losses))
    out_dir = Path(out_dir)
    written = []

    # Figure 1: cumulative training time (reference exp_2_dz_*.pdf).
    fig, ax = plt.subplots(figsize=(4.2, 3.2))
    bars = {"ADMM (per-step)": res["total_time_s"],
            "ADMM (whole horizon)": res["fused_total_s"], **REF_CPU_S}
    ax.bar(range(len(bars)), list(bars.values()),
           color=["C0", "C0", "C7", "C7"])
    ax.set_yscale("log")
    ax.set_xticks(range(len(bars)))
    ax.set_xticklabels(list(bars.keys()), rotation=20, ha="right",
                       fontsize=7)
    ax.set_ylabel(f"training time, {len(losses)} epochs (s)")
    ax.set_title(f"Experiment 2, dz={n_x} ({res['device']})", fontsize=7)
    fig.tight_layout()
    for ext in ("pdf", "png"):
        written.append(out_dir / f"exp2_paper_time_dz_{n_x}_torch.{ext}")
        fig.savefig(str(written[-1]), dpi=120)
    plt.close(fig)

    # Figure 2: loss convergence (reference exp_2_conv_dz_*.pdf).  One
    # deterministic trajectory; the band is the per-step-vs-horizon
    # deviation bound that experiment_2 gates.
    fig, ax = plt.subplots(figsize=(4.2, 3.2))
    ax.plot(epochs, losses, "C0", label="ADMM layer")
    dev = float(res.get("fused_vs_loop_loss_dev", 0.0))
    ax.fill_between(epochs, losses - 2 * dev, losses + 2 * dev,
                    color="C0", alpha=0.25, label="two-path agreement band")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(f"Experiment 2 convergence, dz={n_x}")
    ax.legend(fontsize=7)
    fig.tight_layout()
    for ext in ("pdf", "png"):
        written.append(out_dir / f"exp2_paper_conv_dz_{n_x}_torch.{ext}")
        fig.savefig(str(written[-1]), dpi=120)
    plt.close(fig)
    print("wrote " + ", ".join(str(p) for p in written))
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="store_true",
                    help="run the port's experiment_2 first")
    ap.add_argument("--results", default=None,
                    help=f"the artifact to render (default: "
                         f"<out-dir>/{experiment_2.ARTIFACT})")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.run:
        experiment_2.main(["--device", args.device, "--out-dir",
                           args.out_dir])
    return render(args.results or Path(args.out_dir) / experiment_2.ARTIFACT,
                  args.out_dir)


if __name__ == "__main__":
    main()
