"""Shared benchmark plotting — the role of the reference's
``plot_profile_bars`` (experiments/utils.py:7-32): grouped log-scale bar
charts of median runtimes per solver per size.

Import-guarded: without matplotlib no chart is written, and that is not an
error.
"""

from __future__ import annotations


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def plot_profile_bars(results: dict, out_path, ylabel: str =
                      "median fwd+bwd time (s)", title: str = "",
                      errors: dict = None) -> bool:
    """``results``: {size: {solver_name: seconds}} (``errors`` the same
    layout, for error bars).  Writes a PNG; returns False (without raising)
    when matplotlib is unavailable."""
    plt = pyplot()
    if plt is None:
        return False
    sizes = sorted(results)
    names = sorted({k for r in results.values() for k in r})
    fig, ax = plt.subplots(figsize=(8, 4))
    width = 0.8 / max(len(names), 1)
    for i, name in enumerate(names):
        ys = [results[s].get(name, float("nan")) for s in sizes]
        errs = [(errors or {}).get(s, {}).get(name, 0.0) for s in sizes]
        ax.bar([j + i * width for j in range(len(sizes))], ys, width,
               yerr=errs if errors else None, label=name)
    ax.set_yscale("log")
    ax.set_xticks([j + 0.4 for j in range(len(sizes))])
    ax.set_xticklabels([str(s) for s in sizes])
    ax.set_xlabel("n_x")
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(str(out_path), dpi=120)
    plt.close(fig)
    return True
