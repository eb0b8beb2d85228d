"""Arithmetic shared by several metric readers."""

from __future__ import annotations

from qpbench import roofline
from qpbench import trace as tr


def idle_pct(run):
    """100 (1 - busy / window) of the traced window."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - tr.busy_s(run.trace) / run.trace.window_s)


def share_pct(bound_s: float, kernels) -> float:
    """100 x the roofline's time over the kernels' measured time."""
    t = sum(k.dur for k in kernels)
    return 100.0 * bound_s / t if t > 0 else None


#: The SWEEP leaf kernel (csrc/sweep_spd_inverse.cu), by name.
LEAF_PATTERNS = ("sweep_kernel",)


def leaf_roofline_pct(run):
    """The leaf's launches in the traced window: each launch's bound from
    its tiles (one block per (128, 128) tile: the grid's size), summed,
    over the launches' summed time."""
    if run.trace is None:
        return None
    ks = run.trace.kernels(LEAF_PATTERNS)
    if not ks:
        return None
    bound = 0.0
    for k in ks:
        tiles = k.grid[0] * k.grid[1] * k.grid[2]
        bound += roofline.bound_s(roofline.leaf_flops(tiles),
                                  roofline.leaf_bytes(tiles))
    return share_pct(bound, ks)
