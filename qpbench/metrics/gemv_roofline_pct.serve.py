"""The ADMM loop's P r product against its roofline in the traced solves.

Bytes from shapes: each iteration reads P (B, n, n) and r (B, n) and writes
out (B, n), float32, at the problem's own n (the program's lane padding is
its own cost); times the iterations the solutions report.  Time: the
profiler's device time of the kernels whose names hold one of
``PATTERNS``."""

from qpbench import roofline
from qpbench.metrics_common import share_pct

#: cuBLAS's GEMV kernels, and the port's early-exit GEMV.
PATTERNS = ("gemv",)


def read(run):
    if run.trace is None:
        return None
    ks = run.trace.kernels(PATTERNS)
    iters = sum(r.get("iterations", 0) for r in run.records)
    if not ks or not iters:
        return None
    B = int(run.cell.traffic["batch"])
    n = int(run.cell.config["problem"]["n_x"])
    bound = iters * roofline.bound_s(roofline.gemv_flops(B, n, n),
                                     roofline.gemv_bytes(B, B, n, n))
    return share_pct(bound, ks)
