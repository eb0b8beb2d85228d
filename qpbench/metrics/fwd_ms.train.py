"""Mean device time of the layer's forward call (CUDA events around it on
the stream) over the traced steps."""


def read(run):
    ms = [r["fwd_ms"] for r in run.records if "fwd_ms" in r]
    return sum(ms) / len(ms) if ms else None
