"""The yardstick: published peaks of one H100 and the operations and bytes
of the port's kernels, counted from shapes.

A frozen copy of ``chip_smoke.py``'s ``F32_FLOPS``/``HBM_BYTES_S``,
``_bound`` and ``_gemv_bytes``.  Peaks are NVIDIA's data sheet for the
H100 SXM at 700 W: float32 outside the tensor cores and HBM3.  A share of
the roofline is the bound's time over the measured time; each input byte is
counted once as read and each output byte once as written.
"""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
#: The SWEEP leaf's tile edge (csrc/sweep_spd_inverse.cu).
LEAF = 128


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of the operations at the float32 rate and
    the bytes at the memory rate."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_S)


def gemv_bytes(b: int, n_act: int, m: int, k: int) -> int:
    """Bytes a (b, m, k) float32 GEMV must move with ``n_act`` active
    elements: their P and r read, the frozen elements' x_prev read, every
    element's out written."""
    return 4 * (n_act * (m * k + k) + (b - n_act) * m + b * m)


def gemv_flops(n_act: int, m: int, k: int) -> int:
    return 2 * n_act * m * k


def leaf_bytes(tiles: int) -> int:
    """One SWEEP leaf launch over ``tiles`` (128, 128) float32 tiles: each
    read once and its inverse written once."""
    return 2 * 4 * tiles * LEAF ** 2


def leaf_flops(tiles: int) -> int:
    """n^3 operations per (n, n) tile, as chip_smoke.py counts them."""
    return tiles * LEAF ** 3
