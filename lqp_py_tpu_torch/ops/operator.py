"""Products with a problem's n-column matrices: the seam between the solvers
and the column-sharded ('tp') solves of ``parallel/``.

A solver reaches every matrix with n columns that it multiplies (Q, A, G
and the inverses it factors) through an operator.  ``Dense`` holds them
whole and multiplies as the one-process solve always has;
``parallel/tp_ops.Columns`` holds the rank's column block of each and adds
the collectives.  Vectors of length n, and every piece without an n axis
(``W = Hinv A^T``, the Schur inverses), are whole under both, so a solver's
loop is one loop with either operator.

The primitives, for M, N with n columns (whole, or the rank's block) and
vectors or matrices X whole:

- ``mv(M, x)`` = M x, ``mtv(M, v)`` = M^T v, ``mm(M, X)`` = M X,
  ``mmt(M, N)`` = M N^T;
- ``gram(Gl, Gr)`` = Gl^T Gr for two matrices held alike (``Gr`` defaults
  to ``Gl``; the held columns of it);
- ``add_diag(H, d)`` adds d to the diagonal of a square H in place;
- ``inverse(H)`` = H^-1 of an SPD H (the held columns of it);
- ``row_absmax``, ``col_absmax``: inf-norms of M's rows and columns;
- ``cols(x)``: the held columns of a whole (..., n) tensor;
- ``sum(x)``: a partial sum made whole (the identity here).

``schur``, ``factorize`` and ``kkt_apply`` are built from them, once for
every operator: on ``Dense`` they compute what ``ops/linalg.py``'s
``factorize_kkt`` and ``kkt_apply`` do in inverse mode, bitwise.
"""

from __future__ import annotations

import math

import torch

from lqp_py_tpu_torch.ops.linalg import (KKTFactors, _mv, schur_inverse,
                                         spd_inverse_fast)


class Operator:
    """What ``Dense`` and ``parallel/tp_ops.Columns`` share: the reduced
    KKT pieces, written once in the primitives."""

    def schur(self, Hinv, A, s_reg: float = 0.0):
        """``W = Hinv A^T`` and ``Sinv = (A W + s_reg I)^-1`` (both whole)."""
        W = self.mmt(Hinv, A)
        return W, schur_inverse(self.mm(A, W), s_reg)

    def factorize(self, H, A, materialize_p: bool = False) -> KKTFactors:
        """``factorize_kkt(H, None, A, mode="inverse", materialize_p=...)``
        on this operator; ``P = Hinv - WS W^T`` is held as Hinv is."""
        Hinv = self.inverse(H)
        if A is None:
            return KKTFactors(Hinv=Hinv, P=Hinv if materialize_p else None)
        W, Sinv = self.schur(Hinv, A)
        WS = W @ Sinv
        P = Hinv - WS @ self.cols(W.mT) if materialize_p else None
        return KKTFactors(Hinv=Hinv, W=W, Sinv=Sinv, WS=WS, P=P)

    def kkt_apply(self, f: KKTFactors, r, b):
        """``kkt_apply`` (inverse mode, P not materialized): (x, nu) of
        ``[[H, A^T], [A, 0]] [x; nu] = [r; b]``."""
        y = self.mv(f.Hinv, r)
        if f.W is None:
            return y, None
        nu = _mv(f.Sinv, _mv(f.W.mT, r) - b)
        return y - _mv(f.W, nu), nu


class Dense(Operator):
    """Every n-column matrix held whole: the one-process solve."""

    def cols(self, x):
        return x

    def symmetrize(self, Q):
        return 0.5 * (Q + Q.mT)

    def mv(self, M, x):
        return _mv(M, x)

    def mtv(self, M, v):
        return _mv(M.mT, v)

    def mm(self, M, X):
        return M @ X

    def mmt(self, M, N):
        return M @ N.mT

    def gram(self, Gl, Gr=None):
        return Gl.mT @ (Gl if Gr is None else Gr)

    def add_diag(self, H, d):
        H.diagonal(dim1=-2, dim2=-1).add_(d)
        return H

    def inverse(self, H):
        return spd_inverse_fast(H)

    def row_absmax(self, M):
        return torch.linalg.vector_norm(M, ord=math.inf, dim=-1)

    def col_absmax(self, M):
        return torch.linalg.vector_norm(M, ord=math.inf, dim=-2)

    def sum(self, x):
        return x


DENSE = Dense()
