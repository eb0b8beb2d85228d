"""Adaptive-rho refactorizations per traced solve: the program's
``lqp.factorize`` spans inside its ``lqp.loop`` spans.  A count; 0 is a
reading wherever the trace has loops."""

from qpbench import spans


def read(run):
    return spans.nested_per_unit(run, "lqp.factorize", "lqp.loop")
