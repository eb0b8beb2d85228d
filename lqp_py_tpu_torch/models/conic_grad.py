"""SCS-style implicit differentiation through the conic projection fixed
point (counterpart of ``lqp_py_tpu.models.conic_grad``).

Given a primal-dual solution ``(x, lams, slacks)`` of

    min 0.5 x'Qx + p'x   s.t.  Ax = b,  Gx <= h

the gradients of all six problem data follow from one batched solve of

    (M o D^T - diag(D) + I + 1e-8 I)^T d = D o [-dl_dx; 0]

where ``M = [[Q, Abar^T], [-Abar, 0]]`` with ``Abar = [A; G]`` and ``D`` is
the derivative of the Euclidean projection onto the cone (identity on the
x and zero-cone blocks, a step function on the nonnegative block).

The system is dense and non-symmetric, ``(B, N, N)`` with
``N = n + n_eq + k``: a library LU (``torch.linalg.solve``), as the JAX
package solves it with ``jnp.linalg.solve`` outside any kernel.  For the
box as ``G = [-I; I]`` at B=128, n=1000 it would be ~4.6 GB, so the layer
falls back to the condensed 'kkt' rule above ``CONIC_BACKWARD_MAX_BYTES``
(models/genqp.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from lqp_py_tpu_torch.models.box_qp_grad import _outer, _sym_outer

#: Budget for the materialized (B, N, N) self-dual system.  It decides which
#: backward runs, so it is the JAX package's value: another budget would
#: give other gradients than the JAX package's at the same shape.
CONIC_BACKWARD_MAX_BYTES = 1 << 30


def conic_backward_bytes(B, n, n_eq, k, itemsize) -> int:
    """Bytes of the dense self-dual system the conic backward materializes."""
    N = n + n_eq + k
    return B * N * N * itemsize


def conic_qp_grads(dl_dx, x, lams, slacks, Q, A, G, want_dQ: bool = True,
                   want_dA: bool = True, want_dG: bool = True) -> Tuple:
    """Returns (dQ, dp, dA, db, dG, dh); dA/db are None when A is None.

    ``lams``/``slacks`` belong to the inequality block; the equality
    block's entries are (dual, 0), and its projection derivative is the
    identity whatever the dual.  ``want_*`` = False returns None in place
    of the (B, n, n), (B, m, n) and (B, k, n) outer products.
    """
    B, n = x.shape
    kw = dict(dtype=x.dtype, device=x.device)
    n_eq = 0 if A is None else A.shape[-2]
    Abar = G if A is None else torch.cat([A, G], dim=-2)
    n_con = Abar.shape[-2]

    # w = [x; y - s] with y the duals and s the slacks.
    zeros_eq = torch.zeros((B, n_eq), **kw)
    y_minus_s = torch.cat([zeros_eq, lams - slacks], dim=-1)
    lams_full = torch.cat([zeros_eq, lams], dim=-1)

    # M = [[Q, Abar^T], [-Abar, 0]].
    M = torch.cat([torch.cat([Q, Abar.mT], dim=-1),
                   torch.cat([-Abar, torch.zeros((B, n_con, n_con), **kw)],
                             dim=-1)], dim=-2)

    # Projection derivative: identity on x and the zero cone's block,
    # 0.5 (sign + 1) on the nonnegative block.
    D_y = 0.5 * (torch.sign(y_minus_s[..., n_eq:]) + 1.0)
    D = torch.cat([torch.ones((B, n + n_eq), **kw), D_y], dim=-1)
    rhs = D * torch.cat([-dl_dx, torch.zeros((B, n_con), **kw)], dim=-1)

    # M o D^T - diag(D) + I + 1e-8 I, the diagonal summed in that order.
    mat = M * D[..., None, :]
    del M
    diag = mat.diagonal(dim1=-2, dim2=-1)
    diag.copy_(diag - D + 1.0 + 1e-8)
    d = torch.linalg.solve(mat.mT, rhs[..., None])[..., 0]
    del mat

    dx, dy = d[..., :n], d[..., n:]

    def d_abar(rows):
        return _outer(lams_full[..., rows], dx) - _outer(dy[..., rows], x)

    eq, ineq = slice(0, n_eq), slice(n_eq, None)
    dl_dQ = _sym_outer(dx, x) if want_dQ else None
    dl_dA = dl_db = None
    if A is not None:
        dl_dA = d_abar(eq) if want_dA else None
        dl_db = dy[..., eq]
    dl_dG = d_abar(ineq) if want_dG else None
    return dl_dQ, dx, dl_dA, dl_db, dl_dG, dy[..., ineq]
