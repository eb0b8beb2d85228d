"""Idle device time charged to the program's ``lqp.check`` spans: gaps
that open while the host waits on a residual check's device-to-host read,
mean per traced step."""

from qpbench import spans


def read(run):
    return spans.idle_ms(run, "lqp.check")
