"""Mean device time of the backward pass (CUDA events around the gradient
call) over the traced steps."""


def read(run):
    ms = [r["bwd_ms"] for r in run.records if "bwd_ms" in r]
    return sum(ms) / len(ms) if ms else None
