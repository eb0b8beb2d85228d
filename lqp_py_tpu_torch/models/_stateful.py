"""Shared core of the stateful solve/update wrappers (counterpart of
``lqp_py_tpu.models._stateful``).

The workflow: a cached preparation (scaling + KKT factorization), a p-only
update that keeps the cache, and optional warm starts from the previous
solution.  Subclasses choose the prepare/solve pair and name their two
trailing operands; the cache-invalidation rule lives here once.
"""

from __future__ import annotations

from lqp_py_tpu_torch.types import like_layout


class StatefulQP:
    """Solve/update/re-solve wrapper core.

    Subclasses set ``_extra_fields`` (the names of the two trailing
    operands) and define ``_prepare() -> prep`` and
    ``_solve_prepared(prep, p, warm_start) -> solution``.
    """

    #: names of the two solver-specific trailing operands, in order.
    _extra_fields = ()

    def _init(self, Q, p, A, b, extra1, extra2, control, warm_start):
        self.Q, self.p, self.A, self.b = Q, p, A, b
        f1, f2 = self._extra_fields
        setattr(self, f1, extra1)
        setattr(self, f2, extra2)
        self.control = control
        self.warm_start = warm_start
        self.sol = None
        self._prep = None

    def solve(self):
        ws = self.sol if self.warm_start else None
        if self._prep is None:
            self._prep = self._prepare()
        self.sol = self._solve_prepared(self._prep, self.p, ws)
        return like_layout(self.sol.x, self.p)

    def _update(self, Q, p, A, b, extra1, extra2, control):
        f1, f2 = self._extra_fields
        for name, val in (("Q", Q), ("p", p), ("A", A), ("b", b),
                          (f1, extra1), (f2, extra2), ("control", control)):
            if val is not None:
                setattr(self, name, val)
        # p-only updates keep the cached scaling + factorization (the
        # serving pattern); anything else invalidates it.
        if any(v is not None for v in (Q, A, b, extra1, extra2, control)):
            self._prep = None
