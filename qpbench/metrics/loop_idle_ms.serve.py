"""Idle device time charged to the program's ``lqp.loop`` spans: gaps
that open while the host runs the ADMM loop outside a residual check's
read (the loop's issue rate), mean per traced solve."""

from qpbench import spans


def read(run):
    return spans.idle_ms(run, "lqp.loop")
