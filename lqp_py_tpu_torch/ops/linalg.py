"""Batched KKT factorization and solves (counterpart of
``lqp_py_tpu.ops.linalg``).

The KKT operator

    M = [[H, A^T],
         [A, 0  ]],   H = Q + rho*I  (SPD)

is reduced by a Schur complement on ``Hinv = H^-1``:

    S    = A H^-1 A^T            (n_eq x n_eq, tiny in practice)
    x    = P r + W S^-1 b,       P = H^-1 - W S^-1 W^T,  W = H^-1 A^T
    nu   = S^-1 (W^T r - b)

In mode 'inverse' P is built only on request (the early-exit step's
operand): an ADMM iteration is one dense ``Hinv`` GEMV plus two
rank-``n_eq`` corrections.  Mode 'cholesky' keeps ``L = chol(H)`` and
applies ``H^-1`` by two triangular solves; ``torch.linalg.cholesky_ex``
and ``solve_triangular`` stand for ``lax.linalg``, which the JAX package
runs outside any Pallas kernel, so this mode launches no SWEEP leaf.  A
factorization that fails gives NaN for its element (``cholesky``), as in
the JAX package.
``kkt_solve_cached`` differentiates one factored solve through the cached
factors (the unrolled solve's building block).

``spd_inverse_fast`` picks the inverse by dtype, on every device: float64
takes the Cholesky inverse (as the JAX package does wherever its Pallas
kernel cannot run), float32 takes the block Schur-complement recursion of
GEMMs whose 128x128 diagonal leaves go to ``sweep_spd_inverse`` — the CUDA
kernel for a CUDA tensor, its plain version for a CPU tensor, so the CPU
tests run the algorithm the card runs.  ``spd_solve_fast`` (the backward
pass's solve) dispatches the same way, with the recursion in solve-only
form.  The recursion assembles the inverse in one (B, n, n) buffer, each
block written in its final place by a batched GEMM (``bmm`` / ``baddbmm``
on strided views, the negations and sums in their ``alpha`` and ``beta``)
or by a leaf; only the mirror of each off-diagonal block is a copy
(``mirror_block``, a CUDA kernel on the card).  The solver entry points run
the GEMMs with TF32 off (ops/precision.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from lqp_py_tpu_torch.ops.kernels.mirror import mirror_block
from lqp_py_tpu_torch.ops.kernels.spd_inverse import LEAF, sweep_spd_inverse
from lqp_py_tpu_torch.ops.precision import highest_matmul_precision

#: Below this size the batch-major Gauss-Jordan replaces the 128-padded
#: sweep leaf (a (B, n, n) inverse at n <= 64 would otherwise pad to a
#: full 128x128 sweep).
_GJ_MAX = 64


def _mv(M, v):
    """Batched matrix-vector product ``M @ v`` for (B, i, j) x (B, j)."""
    return (M @ v[..., None])[..., 0]


def cholesky(H):
    """Lower Cholesky factor of a batch of SPD matrices.  An element whose
    factorization fails comes back NaN, as ``jnp.linalg.cholesky`` returns
    it, so that its solve turns NaN and a caller's per-element acceptance
    test rejects it; nothing raises, and the host does not wait for the
    device's error flags."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def chol_solve(L, rhs):
    """Solve ``(L L^T) x = rhs`` for batched lower-triangular ``L``.

    ``rhs`` is ``(..., n)`` or ``(..., n, k)``.
    """
    vec = rhs.ndim == L.ndim - 1
    if vec:
        rhs = rhs[..., None]
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vec else x


def chol_inverse(L):
    """Explicit SPD inverse ``H^-1 = L^-T L^-1`` from a lower Cholesky
    factor: a triangular solve against the identity, then one GEMM."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Linv.mT @ Linv


def spd_inverse(H):
    return chol_inverse(cholesky(H))


def _sweep_leaf(H, out=None):
    # The recursion's diagonal-block views go to the leaf as they are (the
    # kernel reads and writes through their row strides); only an operand
    # without unit column stride, such as a transpose from a caller, is
    # copied.
    return sweep_spd_inverse(H if H.stride(-1) == 1 else H.contiguous(),
                             out=out)


def _gj_inverse_small(H):
    """SPD inverse for small n by the symmetric sweep recurrence, batch
    last so that each pivot step is one vectorized rank-1 pass over
    (n, n, B).  Written as ``u = row - e_k``, which needs ``A[k,k] -= 2``
    after the rank-1 update."""
    n = H.shape[-1]
    X = H.movedim(0, -1).clone()                     # (n, n, B)
    iota = torch.arange(n, device=H.device)
    for k in range(n):
        onehot = (iota == k).to(H.dtype)[:, None]   # (n, 1)
        row = X[k]                                  # (n, B)
        u = row - onehot
        v = u / row[k]
        X = X - u[:, None, :] * v[None, :, :]
        X[k, k] -= 2.0
    return -X.movedim(-1, 0)


def _refuse_autograd(*operands):
    """The in-place GEMMs record no autograd graph, so an operand that
    autograd would differentiate raises (the solvers' autograd Functions
    run their factorizations without one)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("the Schur recursion assembles in place and is "
                           "not differentiable: call it under no_grad")


def _halves_into(H, W, leaf, mirror, h):
    """The half of a node split at h that both forms of the recursion
    share, written into W (which may be H): ``Ai`` in its top-left,
    ``T^T = B^T Ai`` in its bottom-left and ``Si = (C - B^T Ai B)^-1`` in
    its bottom-right.  Only H's blocks on and above the diagonal at the
    splits are read; where W is not H, C is copied into W once before its
    GEMM updates it.  Returns the views (B, Ai, T^T, Si)."""
    Bm, C = H[:, :h, h:], H[:, h:, h:]
    Ai, Tt, Si = W[:, :h, :h], W[:, h:, :h], W[:, h:, h:]
    _invert_into(H[:, :h, :h], Ai, leaf, mirror)
    torch.bmm(Bm.mT, Ai, out=Tt)                     # T^T = B^T Ai
    if Si.data_ptr() != C.data_ptr():
        Si.copy_(C)
    Si.baddbmm_(Tt, Bm, alpha=-1)                    # S = C - B^T Ai B
    _invert_into(Si, Si, leaf, mirror)
    return Bm, Ai, Tt, Si


def _invert_into(H, out, leaf, mirror):
    """``out <- H^-1`` for (B, n, n) views with n a multiple of LEAF;
    ``out`` may be H.  Splits at a multiple of LEAF; after the shared half
    (``_halves_into``) ``-U = -T Si`` goes to the top-right, ``Ai + U T^T``
    onto ``Ai``, and ``mirror`` writes ``(-U)^T`` over ``T^T``."""
    n = H.shape[-1]
    if n <= LEAF:
        leaf(H, out=out)
        return
    h = (n // LEAF // 2) * LEAF
    _, Ai, Tt, Si = _halves_into(H, out, leaf, mirror, h)
    TR = out[:, :h, h:]
    TR.baddbmm_(Tt.mT, Si, beta=0, alpha=-1)         # -U = -T Si
    Ai.baddbmm_(TR, Tt, alpha=-1)                    # Ai + U T^T
    mirror(TR, Tt)                                   # (-U)^T


def _schur_inverse(H, leaf=_sweep_leaf, out=None, mirror=None):
    """Recursive SPD inverse; H is (B, n, n) with n a multiple of LEAF.

    Splits at a multiple of LEAF, inverts the leading block and its Schur
    complement recursively, and assembles the inverse with GEMMs in one
    buffer (``_invert_into``); ``leaf(X, out=Y)`` inverts the 128x128
    diagonal blocks and ``mirror(src, out)`` (default ``mirror_block``)
    writes each off-diagonal block's transpose: the plain versions of both
    give the plain recursion.  The result goes to ``out`` where one is
    given (H itself to overwrite it), else to a new buffer; H is not
    written otherwise."""
    _refuse_autograd(H)
    if out is None:
        out = H.new_empty(H.shape)
    _invert_into(H, out, leaf, mirror or mirror_block)
    return out


def _equilibrate(H):
    """``(D H D, D)`` with ``D = diag(H)^-1/2`` as a (B, n) vector."""
    d = torch.rsqrt(torch.clamp(H.diagonal(dim1=-2, dim2=-1), min=1e-30))
    return H * d[..., :, None] * d[..., None, :], d


def _pad_to_leaf(H):
    """(B, n, n) -> (B, n_pad, n_pad) with n_pad the next multiple of LEAF
    and an identity block in the pad (exact: the inverse of
    blockdiag(H, I) is blockdiag(H^-1, I)); H itself where n is one.

    Only what the recursion reads is written, each element once: every
    LEAF-row band from its diagonal block rightwards.  The blocks below
    the diagonal blocks are left unwritten, for the recursion to fill."""
    n = H.shape[-1]
    n_pad = -(-n // LEAF) * LEAF
    if n_pad == n:
        return H
    Hp = H.new_empty((H.shape[0], n_pad, n_pad))
    for i in range(0, n, LEAF):
        Hp[:, i:min(i + LEAF, n), i:n] = H[:, i:i + LEAF, i:]
    Hp[:, :n, n:].zero_()
    Hp[:, n:, n_pad - LEAF:n].zero_()          # the pad rows' band
    Hp[:, n:, n:] = torch.eye(n_pad - n, dtype=H.dtype, device=H.device)
    return Hp


def spd_inverse_fast(H, equilibrate: bool = True):
    """SPD inverse of (B, n, n).

    float64: Cholesky.  float32: the Schur recursion with sweep leaves
    (``n`` padded to a multiple of 128 with an identity block), or the
    batch-major Gauss-Jordan for n <= 64.

    With ``equilibrate=True`` the input is Jacobi-equilibrated first
    (``H' = D H D`` with ``D = diag(H)^-1/2``) and the result unscaled as
    ``H^-1 = D H'^-1 D``; a fixed-order float32 sweep loses all accuracy on
    a diagonal with a wide dynamic range.  Callers whose operand is
    already equilibrated (the box-QP solver Jacobi-scales Q) pass False."""
    if H.dtype != torch.float32:
        return spd_inverse(H)
    Hs, d = _equilibrate(H) if equilibrate else (H, None)
    n = H.shape[-1]
    if n <= _GJ_MAX:
        Hi = _gj_inverse_small(Hs)
    else:
        # A copy made here (padded or equilibrated) is inverted in place.
        Hp = _pad_to_leaf(Hs)
        Hi = _schur_inverse(Hp, out=None if Hp is H else Hp)[:, :n, :n]
    if d is None:
        return Hi
    return Hi * d[..., :, None] * d[..., None, :]


def _schur_solve_rec(H, R, leaf=_sweep_leaf, work=None, mirror=None):
    """``H^-1 R`` without materializing the full inverse: the two half-size
    diagonal blocks are inverted (``_invert_into``, sweep leaves) but the
    cross-block pieces are only applied to ``R``.

    H: (B, n, n) SPD with n a multiple of LEAF; R: (B, n, k).  The blocks
    go to ``work`` (B, n, n), which may be H to overwrite it, else to a new
    buffer; X1 and X2 are written into one new (B, n, k) result.
    ``leaf`` and ``mirror`` as in ``_schur_inverse``."""
    _refuse_autograd(H, R)
    mirror = mirror or mirror_block
    n = H.shape[-1]
    W = H.new_empty(H.shape) if work is None else work
    X = R.new_empty(R.shape)
    if n <= 2 * LEAF:
        _invert_into(H, W, leaf, mirror)
        return torch.bmm(W, R, out=X)
    h = (n // LEAF // 2) * LEAF
    Bm, Ai, Tt, Si = _halves_into(H, W, leaf, mirror, h)
    X1, X2 = X[:, :h], X[:, h:]
    torch.bmm(Ai, R[:, :h], out=X1)                  # Y1 = Ai R1
    torch.bmm(Si, torch.baddbmm(R[:, h:], Bm.mT, X1, alpha=-1), out=X2)
    X1.baddbmm_(Tt.mT, X2, alpha=-1)                 # Y1 - T X2
    return X


def spd_solve_fast(H, R, equilibrate: bool = True,
                   precision: str = "highest"):
    """Solve ``H X = R`` for SPD (B, n, n) H and (B, n, k) R.

    float64: a Cholesky solve.  float32, on every device: the Schur
    recursion in solve-only form (``_schur_solve_rec``) with sweep leaves,
    ``n`` padded to a multiple of 128 with an identity block (and R with
    zero rows), or the batch-major Gauss-Jordan inverse for n <= 64.

    ``equilibrate`` as in ``spd_inverse_fast``; pass False when the operand
    is already (approximately) unit-diagonal.  ``precision`` is accepted for
    the JAX package's signature and ignored: the JAX package picks a bf16
    pass count for the TPU's matrix unit here, and the port's GEMMs run in
    full float32 (TF32 stays off at every solver entry point)."""
    del precision
    if H.dtype != torch.float32:
        return chol_solve(cholesky(H), R)
    if equilibrate:
        Hs, d = _equilibrate(H)
        Rs = R * d[..., :, None]
    else:
        Hs, Rs, d = H, R, None
    n = H.shape[-1]
    if n <= _GJ_MAX:
        X = _gj_inverse_small(Hs) @ Rs
    else:
        Hp = _pad_to_leaf(Hs)
        Rp = F.pad(Rs, (0, 0, 0, Hp.shape[-1] - n))
        X = _schur_solve_rec(Hp, Rp, work=None if Hp is H else Hp)[:, :n, :]
    if d is None:
        return X
    return X * d[..., :, None]


@dataclasses.dataclass
class KKTFactors:
    """Factorization state of the reduced KKT operator.

    Mode 'inverse': ``Hinv = (Q + rho I)^-1`` plus the low-rank pieces
    ``W = H^-1 A^T``, ``WS = W S^-1`` and ``Sinv = (A H^-1 A^T)^-1``; the
    reduced inverse ``P = Hinv - WS W^T`` is applied implicitly unless
    materialized (``P``, else None).  Mode 'cholesky': ``L = chol(H)``,
    ``W`` and ``Sinv``; ``Hinv``, ``WS`` and ``P`` are None.
    ``W``/``WS``/``Sinv`` are None when n_eq == 0.
    """

    Hinv: Optional[torch.Tensor] = None
    W: Optional[torch.Tensor] = None
    Sinv: Optional[torch.Tensor] = None
    WS: Optional[torch.Tensor] = None
    P: Optional[torch.Tensor] = None
    L: Optional[torch.Tensor] = None


def _schur_pieces(A, W, s_reg):
    """``Sinv = (A W + s_reg I)^-1`` for W = H^-1 A^T."""
    return schur_inverse(A @ W, s_reg)              # (B, m, m)


def schur_inverse(S, s_reg: float = 0.0):
    """``(S + s_reg I)^-1`` of the SPD Schur complement ``S = A W``."""
    if s_reg:
        S = S + s_reg * torch.eye(S.shape[-1], dtype=S.dtype,
                                  device=S.device)
    return spd_inverse(S)


def factorize_kkt(Q, rho, A, *, mode: str = "inverse", s_reg: float = 0.0,
                  equilibrate: bool = True,
                  materialize_p: bool = False) -> KKTFactors:
    """Factorize ``M = [[Q + rho I, A^T], [A, 0]]`` (batched).

    Q:   (B, n, n) SPD
    rho: (B,) or scalar — per-element ADMM penalty.  ``None`` means Q is
      already the shifted operand ``H`` (``scale_problem_h``).
    A:   (B, m, n) or None
    mode: 'inverse' (``spd_inverse_fast``) or 'cholesky' (``L = chol(H)``).
    s_reg: Tikhonov term added to the Schur complement.
    equilibrate: passed to ``spd_inverse_fast``.
    materialize_p: also build the dense reduced inverse ``P`` (the operator
      of the early-exit step); ``P`` is ``Hinv`` itself when A is None.
      Inverse mode only.
    """
    if rho is None:
        H = Q
    else:
        rho = torch.as_tensor(rho, dtype=Q.dtype, device=Q.device)
        rho_diag = (rho[..., None, None] if rho.ndim == 1 else rho)
        H = Q + rho_diag * torch.eye(Q.shape[-1], dtype=Q.dtype,
                                     device=Q.device)
    if mode == "cholesky":
        L = cholesky(H)
        if A is None:
            return KKTFactors(L=L)
        W = chol_solve(L, A.mT)                     # (B, n, m)
        return KKTFactors(L=L, W=W, Sinv=_schur_pieces(A, W, s_reg))
    if mode != "inverse":
        raise ValueError(f"unknown kkt_solver {mode!r}")
    Hinv = spd_inverse_fast(H, equilibrate=equilibrate)
    if A is None:
        return KKTFactors(Hinv=Hinv, P=Hinv if materialize_p else None)
    W = Hinv @ A.mT                                 # (B, n, m)
    Sinv = _schur_pieces(A, W, s_reg)
    WS = W @ Sinv
    P = Hinv - WS @ W.mT if materialize_p else None
    return KKTFactors(Hinv=Hinv, W=W, Sinv=Sinv, WS=WS, P=P)


def kkt_apply(f: KKTFactors, r, b):
    """Apply the factored KKT inverse: solve M [x; nu] = [r; b].

    r: (B, n); b: (B, m) or None.  Returns (x, nu).
    """
    dense = f.P if f.P is not None else f.Hinv
    if f.W is None:
        x = _mv(dense, r) if dense is not None else chol_solve(f.L, r)
        return x, None
    nu = _mv(f.Sinv, _mv(f.W.mT, r) - b)
    if f.P is not None:
        # x = P r + W Sinv b
        return _mv(f.P, r) + _mv(f.W, _mv(f.Sinv, b)), nu
    y = _mv(f.Hinv, r) if f.Hinv is not None else chol_solve(f.L, r)
    return y - _mv(f.W, nu), nu


def kkt_step_operator(f: KKTFactors, b):
    """``(dense, q)`` such that the ADMM x-update is ``x = P r + q``
    (``dense`` is the materialized ``P``) or ``x = Hinv r - WS (W^T r) + q``
    (``dense`` is ``Hinv``), with the constant ``q = W Sinv b``; None
    outside inverse mode (the caller takes ``kkt_apply``)."""
    dense = f.P if f.P is not None else f.Hinv
    if dense is None:
        return None
    if f.W is None or b is None:
        q = dense.new_zeros(dense.shape[:-1])
    else:
        q = _mv(f.W, _mv(f.Sinv, b))
    return dense, q


class _KKTSolveCached(torch.autograd.Function):
    """``[x; nu] = M(Q, A)^-1 [r; b]`` through prefactored, detached
    factors.  The backward is one more factored solve: with
    ``[dx; dnu] = M^-1 [-g_x; -g_nu]``, ``dQ = dx x^T``,
    ``dA = dnu x^T + nu dx^T``, ``dr = -dx`` and ``db = -dnu``.  The factors
    get no gradient."""

    @staticmethod
    def forward(ctx, factors, Q, A, r, b):
        x, nu = kkt_apply(factors, r, b)
        ctx.factors = factors
        ctx.save_for_backward(x, nu)
        return (x,) if nu is None else (x, nu)

    @staticmethod
    def backward(ctx, g_x, g_nu=None):
        x, nu = ctx.saved_tensors
        need = ctx.needs_input_grad          # (factors, Q, A, r, b)
        if nu is not None and g_nu is None:
            g_nu = torch.zeros_like(nu)
        with highest_matmul_precision():
            dx, dnu = kkt_apply(ctx.factors, -g_x,
                                None if nu is None else -g_nu)
            dQ = dx[..., :, None] * x[..., None, :] if need[1] else None
            dA = db = None
            if nu is not None:
                if need[2]:
                    dA = (dnu[..., :, None] * x[..., None, :]
                          + nu[..., :, None] * dx[..., None, :])
                db = -dnu
        return None, dQ, dA, -dx, db


def kkt_solve_cached(factors: KKTFactors, Q, A, r, b):
    """Solve ``M(Q, A) [x; nu] = [r; b]`` with prefactored ``factors``
    (built from detached operands).  Gradients flow to Q, A, r and b, and
    none to the factors.  ``A``/``b`` may be None; returns ``(x, nu)``
    with ``nu`` None then."""
    out = _KKTSolveCached.apply(factors, Q, A, r, b)
    return (out[0], None) if len(out) == 1 else out
