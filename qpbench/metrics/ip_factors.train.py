"""The interior point's per-iteration factorizations per traced step: the
program's ``lqp.factorize`` spans inside its ``lqp.loop`` spans (one per
IP iteration; the first factorization, the polish's and the backward's lie
outside the loop).  A count; None where the trace has no loop span."""

from qpbench import spans


def read(run):
    return spans.nested_per_unit(run, "lqp.factorize", "lqp.loop")
