"""Column-block algebra of the tensor-parallel ('tp') solves: the rank's
place on the 'tp' axis, its collectives, the distributed SPD inverse, and
``Columns``, the operator (``ops/operator.py``) through which every solver
family runs on column blocks.

Each (dp, tp) rank holds its batch shard and, of every matrix with n
columns (Q, A, G and the inverses factored from them), the block of its
columns; vectors and every piece without n columns are whole over 'tp'.
Every collective is placed by hand on the 'tp' group, with ``broadcast``
and ``all_reduce`` only (gloo's two collectives on CUDA tensors); an
all-gather is an all-reduce of a zero-filled buffer.  Every broadcast
operand is contiguous: under gloo a strided view broadcasts wrong values.

For a (B, k, L) block ``Gc`` of a (B, k, n) matrix G and whole vectors:

- ``G x``: a local partial product plus one all-reduce of (B, k);
- ``G^T v``: local on the rank's columns, then gathered to (B, n);
- row norms of G: a partial maximum plus an all-reduce, column norms
  local and gathered;
- the Gram block ``(Gl^T Gr)[:, :, mine]`` (``Gl`` = G or diag(w) G, ``Gr``
  likewise), the one product that needs other ranks' columns: each rank
  broadcasts its block of ``Gl`` in turn and every rank puts
  ``Gl_s^T Gr_c`` into its rows ``cols(s)``; no rank keeps another rank's
  block after its turn;
- the inverse of an SPD matrix held in column blocks:
  ``column_spd_inverse``, a block Gauss-Jordan sweep over column panels
  (the algorithm of ``ops/kernels/block_inverse.py``, distributed; the JAX
  package's GSPMD partitions a Cholesky recursion instead), each pivot tile
  inverted by the SWEEP leaf in float32;
- the lower Cholesky factor of such a matrix: ``column_cholesky``, a
  right-looking blocked Cholesky over the same panels (one broadcast per
  panel), and the triangular sweeps ``L y = r`` and ``L^T x = y`` on its
  column blocks, one rank after another (``forward_sweep``,
  ``backward_sweep``, ``column_chol_solve``): about t broadcasts of the
  right-hand side per sweep.

Columns are cut into blocks of ``L`` per rank, where ``L`` is n/t rounded
up to the pivot width ``w = min(128, ceil(n/t))``: rank c holds columns
``[c L, min((c+1) L, n))``, and the padded operator of the inverse (size
``N = t L``, identity on the pad) has no panel across two ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops.kernels.spd_inverse import LEAF
from lqp_py_tpu_torch.ops.linalg import _mv
from lqp_py_tpu_torch.ops.operator import Operator

#: Column-sharded factorizations run in this process.
FACTORIZATIONS = 0


def column_blocks(n: int, t: int):
    """``(L, w)``: columns per rank and pivot width for n over t ranks."""
    n_loc = -(-n // t)
    w = min(LEAF, n_loc)
    return -(-n_loc // w) * w, w


class _TP:
    """The rank's place on the mesh's 'tp' axis and the collectives of the
    sharded operator.  ``held`` is the largest working set (bytes) the
    factorization has noted, ``received`` the largest block a Gram
    exchange received from another rank."""

    def __init__(self, mesh: DeviceMesh, model_axis: str, n: int):
        self.group = mesh.get_group(model_axis)
        self.t = dist.get_world_size(self.group)
        self.c = mesh.get_local_rank(model_axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.n = n
        self.L, self.w = column_blocks(n, self.t)
        self.N = self.t * self.L
        self.held = self.received = 0

    def cols(self, s: int) -> slice:
        """Rank s's columns of the unpadded problem."""
        return slice(min(s * self.L, self.n), min((s + 1) * self.L, self.n))

    @property
    def mine(self) -> slice:
        """This rank's columns of the padded operator."""
        return slice(self.c * self.L, (self.c + 1) * self.L)

    def sum(self, x):
        if self.t > 1:
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def max(self, x):
        if self.t > 1:
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def bcast(self, x, owner: int):
        if self.t > 1:
            dist.broadcast(x, src=self.ranks[owner], group=self.group)
        return x

    def gather(self, part, padded: bool = True):
        """(B, N, ...) from every rank's (B, L, ...) block of the padded
        operator, or with ``padded=False`` (B, n, ...) from every rank's
        (B, k, ...) part on its ``cols``: an all-reduce of a zero-filled
        buffer (an all-gather gloo lacks on CUDA tensors)."""
        size, mine = ((self.N, self.mine) if padded
                      else (self.n, self.cols(self.c)))
        full = part.new_zeros((part.shape[0], size, *part.shape[2:]))
        full[:, mine] = part
        return self.sum(full)

    def note(self, *tensors):
        self.held = max(self.held, sum(x.nbytes for x in tensors))


def _tile_inverse(T):
    """Inverse of a (B, w, w) SPD pivot tile.  float32: the SWEEP leaf (the
    CUDA kernel on the card), a tile narrower than the leaf's 128 padded
    with an identity block, which is exact (blockdiag(T, I)^-1 is
    blockdiag(T^-1, I)).  Other types: a Cholesky inverse, as
    ``spd_inverse_fast`` takes."""
    if T.dtype != torch.float32:
        return lin.spd_inverse(T)
    w = T.shape[-1]
    return lin._sweep_leaf(lin._pad_to_leaf(T))[:, :w, :w]


def column_spd_inverse(H, tp: _TP, equilibrate: bool = True):
    """The rank's (B, N, L) columns of ``H^-1`` from its columns of the SPD
    ``H``, by the block sweep over pivot panels of width ``tp.w``:

        D = M[K, K];  V = M[:, K] D^-1;  M -= V M[:, K]^T;
        M[:, K] = V;  M[K, :] = V^T;  M[K, K] = -D^-1

    after which M = -H^-1.  A rank's share of ``M -= V M[:, K]^T`` is
    ``M[:, J] -= V M[K, J]`` (M stays symmetric), so a panel costs its
    owner one tile inverse and one (B, N, w) broadcast, and every rank one
    batched GEMM on its own columns.  ``equilibrate``: Jacobi-equilibrate
    first, as ``spd_inverse_fast`` does."""
    global FACTORIZATIONS
    B, N, L = H.shape
    mine, w, c = tp.mine, tp.w, tp.c
    d = None
    if equilibrate:
        d = torch.rsqrt(torch.clamp(tp.gather(
            H[:, mine, :].diagonal(dim1=-2, dim2=-1)), min=1e-30))
        M = H * d[:, :, None] * d[:, None, mine]
    else:
        M = H.clone()
    for k0 in range(0, N, w):
        owner = k0 // L
        K = slice(k0, k0 + w)
        if owner == c:
            kl = slice(k0 - c * L, k0 - c * L + w)
            C = M[:, :, kl]
            Dinv = _tile_inverse(C[:, K, :])
            V = C @ Dinv
        else:
            V = M.new_empty((B, N, w))
        tp.bcast(V, owner)
        R = M[:, K, :].clone()
        tp.note(H, M, V, R)
        M.baddbmm_(V, R, alpha=-1.0)
        M[:, K, :] = V[:, mine, :].mT
        if owner == c:
            M[:, :, kl] = V
            M[:, K, kl] = -Dinv
    FACTORIZATIONS += 1
    M.neg_()
    if d is not None:
        M *= d[:, :, None] * d[:, None, mine]
    return M


def column_cholesky(H, tp: _TP):
    """The rank's (B, N, L) columns of the lower Cholesky factor of the
    padded SPD ``H`` from its columns of H, by a right-looking blocked
    Cholesky over the pivot panels of width ``tp.w``:

        L_KK = chol(M[K, K]);  L[K+, K] = M[K+, K] L_KK^-T;
        M[K+, J] -= L[K+, K] L[J, K]^T   for the columns J after K

    The panel's owner factors its tile (``ops/linalg.cholesky``: a tile
    that is not SPD turns NaN, nothing raises), solves the rows below it
    and broadcasts the panel's rows from K on; every rank updates only its
    own later columns.  An element whose tile failed on any panel comes
    back NaN in every rank's block, as ``ops/linalg.cholesky`` returns it.  One (B, N - k, w) broadcast per panel, as
    ``column_spd_inverse``; no leaf and no equilibration, as the
    one-process Cholesky mode.  The identity pad stays identity."""
    global FACTORIZATIONS
    B, N, L = H.shape
    w, c = tp.w, tp.c
    M = H.clone()
    failed = torch.zeros((B,), dtype=torch.bool, device=H.device)
    for k0 in range(0, N, w):
        owner, k1 = k0 // L, k0 + w
        if owner == c:
            kl = slice(k0 - c * L, k1 - c * L)
            Lkk = lin.cholesky(M[:, k0:k1, kl])
            below = torch.linalg.solve_triangular(Lkk.mT, M[:, k1:, kl],
                                                  upper=True, left=False)
            V = torch.cat([Lkk, below], dim=1)
        else:
            V = M.new_empty((B, N - k0, w))
        tp.bcast(V, owner)
        tp.note(H, M, V)
        failed |= torch.isnan(V[:, 0, 0])
        j0 = max(k1 - c * L, 0)          # the rank's first column after K
        if j0 < L:
            M[:, k1:, j0:].baddbmm_(
                V[:, w:], V[:, c * L + j0 - k0:(c + 1) * L - k0].mT,
                alpha=-1.0)
        if owner == c:
            M[:, :k0, kl] = 0.0
            M[:, k0:, kl] = V
    FACTORIZATIONS += 1
    return M.masked_fill_(failed[:, None, None], torch.nan)


def forward_sweep(Lc, r, tp: _TP, replicate: bool = True):
    """``L^-1 r`` for the factor held as the ranks' (B, N, L) column blocks
    ``Lc`` and a whole r, (B, N) or (B, N, m).  Column by column: rank 0
    solves its diagonal block, takes its columns' share out of the rows
    below, and broadcasts the vector to rank 1, and so on; t broadcasts,
    the result whole on every rank.  Without ``replicate`` the last
    broadcast is left out: the result is whole on rank t-1 alone, which is
    what ``backward_sweep`` starts from."""
    vec = r.ndim == 2
    y = (r[..., None] if vec else r).clone(
        memory_format=torch.contiguous_format)
    mine = tp.mine
    for s in range(tp.t):
        if s == tp.c:
            ys = torch.linalg.solve_triangular(Lc[:, mine, :], y[:, mine],
                                               upper=False)
            y[:, mine] = ys
            y[:, mine.stop:].baddbmm_(Lc[:, mine.stop:, :], ys, alpha=-1.0)
        if replicate or s < tp.t - 1:
            tp.bcast(y, s)
    return y[..., 0] if vec else y


def backward_sweep(Lc, y, tp: _TP):
    """``L^-T y`` for ``Lc`` as in ``forward_sweep``, from the last rank to
    the first: row block K of ``L^T`` is column block K of L, so each rank
    needs its own columns and the x its successors found.  t broadcasts,
    the result whole on every rank."""
    vec = y.ndim == 2
    x = (y[..., None] if vec else y).clone(
        memory_format=torch.contiguous_format)
    mine = tp.mine
    for s in reversed(range(tp.t)):
        if s == tp.c:
            rhs = x[:, mine] - Lc[:, mine.stop:, :].mT @ x[:, mine.stop:]
            x[:, mine] = torch.linalg.solve_triangular(
                Lc[:, mine, :].mT, rhs, upper=True)
        tp.bcast(x, s)
    return x[..., 0] if vec else x


def column_chol_solve(Lc, r, tp: _TP):
    """``(L L^T)^-1 r``, whole on every rank: the two sweeps, 2t - 1
    broadcasts."""
    return backward_sweep(Lc, forward_sweep(Lc, r, tp, replicate=False), tp)


def _symmetrize(Q, tp: _TP):
    """The rank's columns of 0.5 (Q + Q^T) from its columns of Q: rank s's
    block, broadcast in turn, holds Q's rows of this rank's columns."""
    out = 0.5 * Q
    for s in range(tp.t):
        cols = tp.cols(s)
        if cols.stop == cols.start:
            continue
        blk = Q.contiguous() if s == tp.c else Q.new_empty(
            (Q.shape[0], tp.n, cols.stop - cols.start))
        tp.bcast(blk, s)
        out[:, cols, :] += 0.5 * blk[:, tp.cols(tp.c), :].mT
    return out


class Columns(Operator):
    """``ops/operator.Dense`` on the rank's column blocks: every matrix
    with n columns is its (B, rows, k) block of the rank's ``cols``;
    vectors and the results below are whole.

    ``padded``: the columns are those of the padded operator instead (size
    N, the rank's block ``mine`` of L columns, vectors of length N), whose
    square matrices are SPD with identity on the pad, as the box ADMM
    keeps them; ``equilibrate`` is ``column_spd_inverse``'s."""

    def __init__(self, tp: _TP, padded: bool = False,
                 equilibrate: bool = True):
        self.tp, self.padded, self.equilibrate = tp, padded, equilibrate
        self.k = tp.mine if padded else tp.cols(tp.c)

    def cols(self, x):
        return x[..., self.k]

    def symmetrize(self, Q):
        return _symmetrize(Q, self.tp)

    def mv(self, M, x):
        return self.tp.sum(_mv(M, x[:, self.k]))

    def mtv(self, M, v):
        return self.tp.gather(_mv(M.mT, v), self.padded)

    def mm(self, M, X):
        return self.tp.sum(M @ X[:, self.k])

    def mmt(self, M, N):
        return self.tp.sum(M @ N.mT)

    def gram(self, Gl, Gr=None):
        """The rank's (B, n, k) columns of ``Gl^T Gr`` (``Gr`` defaults to
        ``Gl``): rank s's block of ``Gl``, broadcast in turn, gives the
        rows ``cols(s)``.  Unpadded columns only."""
        tp = self.tp
        Gr = Gl if Gr is None else Gr
        out = Gl.new_empty((Gl.shape[0], tp.n, Gl.shape[-1]))
        for s in range(tp.t):
            cs = tp.cols(s)
            if cs.stop == cs.start:
                continue
            if s == tp.c:
                blk = Gl.contiguous()
            else:
                blk = Gl.new_empty((Gl.shape[0], Gl.shape[1],
                                    cs.stop - cs.start))
                tp.received = max(tp.received, blk.nbytes)
            tp.bcast(blk, s)
            out[:, cs, :] = blk.mT @ Gr
        return out

    def add_diag(self, H, d):
        size = self.tp.N if self.padded else self.tp.n
        if torch.is_tensor(d) and d.ndim and d.shape[-1] == size:
            d = d[..., self.k]
        H[:, self.k, :].diagonal(dim1=-2, dim2=-1).add_(d)
        return H

    def inverse(self, H):
        """The rank's (B, n, k) columns of ``H^-1``: a view into the (B, N,
        L) block of the padded operator (identity on the pad), which a
        ``padded`` operator holds already."""
        tp = self.tp
        if self.padded:
            return column_spd_inverse(H, tp, self.equilibrate)
        B, n, k = H.shape
        Hp = H.new_zeros((B, tp.N, tp.L))
        Hp[:, :n, :k] = H
        Hp[:, tp.mine, :].diagonal(dim1=-2, dim2=-1)[:, k:] = 1.0
        return column_spd_inverse(Hp, tp, self.equilibrate)[:, :n, :k]

    def row_absmax(self, M):
        part = (M.abs().amax(dim=-1) if M.shape[-1]
                else M.new_zeros(M.shape[:-1]))   # a rank with no columns
        return self.tp.max(part)

    def col_absmax(self, M):
        return self.tp.gather(M.abs().amax(dim=-2), self.padded)

    def sum(self, x):
        return self.tp.sum(x)
