"""The import guard: the port's benchmark runs without JAX and without the
JAX package.  Names are compared by their top-level part whole, so
``lqp_py_tpu_torch`` (the port) is not ``lqp_py_tpu`` (the JAX package)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lqp_py_tpu"})


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)
