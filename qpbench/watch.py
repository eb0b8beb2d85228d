"""What a layer's forward solve reports of its convergence.

A layer returns ``x`` alone, so the adapter watches the solve that the
layer's autograd function calls (a module-level name of the port, looked
up at call time) while the layer runs, and keeps the solution's
``converged`` flags: the timed path's own, read without a host sync."""

from __future__ import annotations


class Seen:
    """``with Seen(module, name) as seen:`` wraps ``module.name`` for the
    block; ``seen.ok`` is then ``converged.all()`` of the last solution it
    returned (a 0-d bool tensor), or None if it was not called."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.ok = None

    def __enter__(self):
        real = getattr(self.module, self.name)
        self.real = real

        def watched(*args, **kw):
            sol = real(*args, **kw)
            self.ok = sol.converged.all()
            return sol
        setattr(self.module, self.name, watched)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False
