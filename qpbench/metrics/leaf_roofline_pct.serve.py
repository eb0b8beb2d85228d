"""The SWEEP leaf kernel's share of its roofline in the traced solves."""

from qpbench.metrics_common import leaf_roofline_pct as read  # noqa: F401
