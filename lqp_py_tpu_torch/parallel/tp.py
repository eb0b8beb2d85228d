"""Tensor-parallel ('tp') column sharding of the box-QP KKT operator
(counterpart of ``lqp_py_tpu.parallel.tp`` for ``solver="box"``).

The batch axis ('dp') is embarrassingly parallel; 'tp' is for the other
direction, a problem whose n makes the (B, n, n) reduced inverse too large
for one card.  Each (dp, tp) rank holds its batch shard and a block of
columns of Q and A; vectors are replicated over 'tp'.  The JAX package gets
the partitioned solve from GSPMD (with lax Cholesky leaves, which it can
partition); here every collective is placed by hand, on the 'tp' group,
with ``broadcast`` and ``all_reduce`` only (gloo's two collectives on CUDA
tensors):

- **Scaling.**  Q's column norms are local to the column block: one
  all-reduce of a zero-filled (B, n) buffer assembles them, and D is
  replicated.  The auto-rho ``||D Q D||_F`` is a partial sum plus an
  all-reduce; A's row norms are a partial maximum plus an all-reduce.
  ``symmetrize`` needs Q's rows of the local columns: each rank broadcasts
  its block in turn.
- **Factorization**, ``H = D Q D + rho I`` inverted by a block
  Gauss-Jordan sweep over column panels (the algorithm of
  ``ops/kernels/block_inverse.py``, distributed; JAX's GSPMD partitions a
  Cholesky recursion instead): for each pivot panel its owner inverts the
  pivot tile (the SWEEP leaf in float32, a Cholesky inverse otherwise, the
  rule of ``spd_inverse_fast``) and broadcasts the (B, n, w) panel column;
  every rank updates its own columns with one batched GEMM.  No rank ever
  holds more than its (B, n, n/t) block and one panel: ``Hinv`` stays
  column-sharded, and the rank-n_eq pieces ``W = Hinv A^T`` and
  ``S = A W`` are partial products plus an all-reduce (small).
- **Loop.**  The x-update ``Hinv r`` is the local product
  ``Hinv[:, :, cols] r[cols]`` plus one all-reduce per iteration; the
  rank-n_eq terms, the clip and the dual update are replicated, and the
  residual check's ``A^T nu`` is one more all-reduce.  The loop itself is
  ``models/box_qp.py``'s, with this module's ``_ColumnKKT`` as its
  operator, so the algorithm is the same step for step; the result matches
  the single-process solve to the solve's tolerance, not bitwise (other
  summation orders, another factorization).  Each residual check's flags
  are all-reduced over every rank of the mesh (dp x tp), so the tp ranks
  leave the loop together even if their replicated vectors ever differed.

A rank needs only its own blocks: ``solve_box_qp_tp_local`` takes them
(``shard_problem_tp`` cuts them from a whole problem, which may stay on the
host, or a caller builds them from ``tp_columns``), so a Q too large for one
card never lies whole on any.  ``solve_box_qp_tp`` takes the whole problem,
as the JAX function does.

Columns are cut into blocks of ``L`` per rank, where ``L`` is n/t rounded
up to the pivot width ``w = min(128, ceil(n/t))``: rank c holds columns
``[c L, min((c+1) L, n))``, which is ``[c n/t, (c+1) n/t)`` whenever t
divides n and n/t is at most 128 or a multiple of it, and the padded
operator (size ``t L``, identity on the pad) has no panel across two
ranks.  This slice takes the default inverse mode only; polish, Anderson,
the early-exit step and the Cholesky mode raise, and the GenQP, OptNet
and box-IP tp solves are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from lqp_py_tpu_torch.config import BoxQPConfig
from lqp_py_tpu_torch.models import box_qp
from lqp_py_tpu_torch.ops import collective
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops import scaling as sca
from lqp_py_tpu_torch.ops.kernels.spd_inverse import LEAF
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.parallel.mesh import mesh_group, shard_batch
from lqp_py_tpu_torch.types import as_vector

#: Column-sharded factorizations run in this process.
FACTORIZATIONS = 0

_MAT_SLOTS = (0, 2)          # Q and A: matrices, by position, never shape
_SLICE = ("the column-sharded (tp) box solve of this port takes the "
          "default inverse mode only; {} on the sharded operator is queued "
          "(ROADMAP Queue 1, item 11b)")


def column_blocks(n: int, t: int):
    """``(L, w)``: columns per rank and pivot width for n over t ranks."""
    n_loc = -(-n // t)
    w = min(LEAF, n_loc)
    return -(-n_loc // w) * w, w


class TPMemory(NamedTuple):
    """Per-rank bytes of one tp solve (``lowered_tp_memory``)."""
    argument_size_in_bytes: int
    temp_size_in_bytes: int


class _TP:
    """The rank's place on the mesh's 'tp' axis and the collectives of the
    sharded operator.  ``held`` is the largest working set (bytes) the
    factorization has noted."""

    def __init__(self, mesh: DeviceMesh, model_axis: str, n: int):
        self.group = mesh.get_group(model_axis)
        self.t = dist.get_world_size(self.group)
        self.c = mesh.get_local_rank(model_axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.n = n
        self.L, self.w = column_blocks(n, self.t)
        self.N = self.t * self.L
        self.held = 0

    def cols(self, s: int) -> slice:
        """Rank s's columns of the unpadded problem."""
        return slice(min(s * self.L, self.n), min((s + 1) * self.L, self.n))

    @property
    def mine(self) -> slice:
        """This rank's columns of the padded operator."""
        return slice(self.c * self.L, (self.c + 1) * self.L)

    def sum(self, x):
        if self.t > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def max(self, x):
        if self.t > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def bcast(self, x, owner: int):
        if self.t > 1:
            dist.broadcast(x, src=self.ranks[owner], group=self.group)
        return x

    def gather(self, part):
        """(B, N, ...) from every rank's (B, L, ...) block: an all-reduce of
        a zero-filled buffer (an all-gather gloo lacks on CUDA tensors)."""
        full = part.new_zeros((part.shape[0], self.N, *part.shape[2:]))
        full[:, self.mine] = part
        return self.sum(full)

    def note(self, *tensors):
        self.held = max(self.held, sum(x.nbytes for x in tensors))


def _check(config: BoxQPConfig):
    for on, what in ((config.polish, "polish"),
                     (config.acceleration, "Anderson acceleration"),
                     (config.use_pallas_step,
                      "the early-exit step (use_pallas_step)"),
                     (config.kkt_solver != "inverse",
                      f"kkt_solver={config.kkt_solver!r}")):
        if on:
            raise NotImplementedError(_SLICE.format(what))


def tp_columns(mesh: DeviceMesh, n: int, model_axis: str = "tp") -> slice:
    """The columns of Q and A (of n) that this rank holds over
    ``model_axis``: ``[c L, min((c+1) L, n))`` (``column_blocks``)."""
    t = mesh.shape[mesh.mesh_dim_names.index(model_axis)]
    L, _ = column_blocks(n, t)
    c = mesh.get_local_rank(model_axis)
    return slice(min(c * L, n), min((c + 1) * L, n))


def shard_problem_tp(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None,
                     ub=None, batch_axis: str = "dp",
                     model_axis: str = "tp", device=None):
    """The rank's part of a problem: the batch shard over ``batch_axis``,
    and of Q and A the column block over ``model_axis`` (``tp_columns``;
    a copy of its own); vectors whole over ``model_axis``, the ``(B, n, 1)``
    layout brought to ``(B, n)``.  Q and A are told apart from vectors by
    their position, never their shape (n = 1 makes a matrix (B, k, 1)).
    ``device``: where the parts go (default: where the operands are), so
    that a whole problem kept on the host puts only its blocks on a card."""
    Q = torch.as_tensor(Q)
    cols = tp_columns(mesh, Q.shape[-1], model_axis)

    def place(i, x):
        if x is None:
            return None
        x = shard_batch(torch.as_tensor(x), mesh, batch_axis)
        if i in _MAT_SLOTS:
            x = x[..., cols]
        elif x.ndim == 3 and x.shape[-1] == 1:     # (B, n, 1) layout
            x = x[..., 0]
        return x.contiguous().to(device)

    return tuple(place(i, x) for i, x in enumerate((Q, p, A, b, lb, ub)))


def solve_box_qp_tp(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None,
                    ub=None, config: BoxQPConfig = BoxQPConfig(),
                    batch_axis: str = "dp", model_axis: str = "tp"):
    """Forward box-QP solve with the KKT operator column-sharded over
    ``model_axis`` and the batch over ``batch_axis``: the algorithm of
    ``solve_box_qp`` (default inverse mode), the layout of
    ``shard_problem_tp``.  Takes the whole problem on every rank (where a
    whole Q does not fit, ``solve_box_qp_tp_local`` takes the rank's
    blocks); returns the rank's batch shard of the ``BoxQPSolution``,
    whole over ``model_axis``."""
    _check(config)
    return solve_box_qp_tp_local(
        mesh, *shard_problem_tp(mesh, Q, p, A, b, lb, ub, batch_axis,
                                model_axis),
        config=config, batch_axis=batch_axis, model_axis=model_axis)


def solve_box_qp_tp_local(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None,
                          ub=None, config: BoxQPConfig = BoxQPConfig(),
                          batch_axis: str = "dp", model_axis: str = "tp"):
    """``solve_box_qp_tp`` on the rank's own part of the problem, as
    ``shard_problem_tp`` gives it: Q (B_loc, n, k) and A (B_loc, m, k) the
    rank's ``tp_columns``, the vectors (B_loc, n) whole.  No rank needs
    more of Q than its block."""
    _check(config)
    tp = _TP(mesh, model_axis, as_vector(p, "p").shape[-1])
    with collective.batch_group(mesh_group(mesh)):
        return _solve_local(tp, Q, p, A, b, lb, ub, config=config)


@solver_precision
def _solve_local(tp: _TP, Q, p, A, b, lb, ub, config):
    """The tp solve on the rank's part (``shard_problem_tp``)."""
    kw = dict(dtype=Q.dtype, device=Q.device)
    n, mine = tp.n, tp.cols(tp.c)
    p = as_vector(p, "p").to(**kw)
    b = None if b is None else as_vector(b, "b").to(**kw)
    A = None if A is None else A.to(**kw)
    B = p.shape[0]
    lb = (torch.full((B, n), -math.inf, **kw) if lb is None
          else as_vector(lb, "lb").to(**kw))
    ub = (torch.full((B, n), math.inf, **kw) if ub is None
          else as_vector(ub, "ub").to(**kw))
    if config.symmetrize:
        Q = _symmetrize(Q, tp)

    p_norm = box_qp._inf_norm(p)
    if config.scale:
        norms = Q.abs().amax(dim=-2)
        D = sca.scaling_from_norms(
            tp.gather(F.pad(norms, (0, tp.L - norms.shape[-1])))[:, :n],
            config.beta)
    else:
        D = torch.ones_like(p)
    d2 = D * D
    q_fro = torch.sqrt(torch.clamp(tp.sum(
        (((Q * Q) @ d2[:, mine, None])[..., 0] * d2).sum(dim=-1)), min=0.0))
    if config.rho is None:
        rho0 = torch.clamp(config.rho_scale * q_fro / math.sqrt(n),
                           config.rho_min, config.rho_max)
    else:
        rho0 = torch.full((B,), float(config.rho), **kw)
    rho0 = torch.where(box_qp._any_finite(lb, ub), rho0,
                       torch.zeros_like(rho0))

    H = _scaled_block(Q, D, rho0, tp)
    del Q
    As = bs = E = None
    if A is not None:
        AD = A * D[:, None, mine]
        if config.scale:
            E = 1.0 / sca._safe_colnorm(tp.max(AD.abs().amax(dim=-1)))
        else:
            E = torch.ones_like(b)
        As = F.pad(E[..., None] * AD, (0, tp.L - AD.shape[-1]))
        bs = E * b
    kkt = _ColumnKKT(H, As, bs, rho0, tp, equilibrate=not config.scale)
    return box_qp._solve_scaled(config, D * p, As, bs, lb / D, ub / D, D, E,
                                p_norm, rho0, None, None, H0=H, kkt=kkt)


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


def _scaled_block(Q, D, rho, tp: _TP):
    """The rank's (B, N, L) block of the padded ``D Q D + rho I``: identity
    on the pad, rho only on the unpadded diagonal."""
    B, n, k = Q.shape
    mine = tp.cols(tp.c)
    H = Q.new_zeros((B, tp.N, tp.L))
    H[:, :n, :k] = D[:, :, None] * Q * D[:, None, mine]
    diag = H[:, tp.mine, :].diagonal(dim1=-2, dim2=-1)
    diag[:, :k] += rho[:, None]
    diag[:, k:] = 1.0
    return H


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


class _ColumnKKT:
    """``models/box_qp._KKTOperator`` on the rank's column block ``H0``
    (B, N, L) and ``As`` (B, m, L) of the padded operator."""

    use_pallas = False

    def __init__(self, H0, As, bs, rho0, tp: _TP, equilibrate: bool):
        self.H0, self.As, self.bs, self.rho0 = H0, As, bs, rho0
        self.tp, self.equilibrate = tp, equilibrate
        self.n, self.n_pad = tp.n, tp.N

    def factorize(self, rho=None) -> lin.KKTFactors:
        tp = self.tp
        H = self.H0
        if rho is not None:
            # The unpadded diagonal only, as the whole-operator solve.
            H = H.clone()
            k = tp.cols(tp.c)
            H[:, tp.mine, :].diagonal(dim1=-2, dim2=-1)[
                :, :k.stop - k.start] += (rho - self.rho0)[:, None]
        Hinv = column_spd_inverse(H, tp, self.equilibrate)
        if self.As is None:
            return lin.KKTFactors(Hinv=Hinv)
        W = tp.sum(Hinv @ self.As.mT)                       # (B, N, m)
        Sinv = lin.spd_inverse(tp.sum(self.As @ W[:, tp.mine]))
        return lin.KKTFactors(Hinv=Hinv, W=W, Sinv=Sinv, WS=W @ Sinv)

    def step_constant(self, f: lin.KKTFactors):
        if f.W is None:
            return self.rho0.new_zeros((self.rho0.shape[0], self.n_pad))
        return lin._mv(f.W, lin._mv(f.Sinv, self.bs))

    def x_update(self, f: lin.KKTFactors, q, r):
        y = self.tp.sum(lin._mv(f.Hinv, r[:, self.tp.mine]))
        if f.W is not None:
            y = y - lin._mv(f.WS, lin._mv(f.W.mT, r))
        return y + q

    def at_mv(self, *vs):
        part = torch.stack([lin._mv(self.As.mT, v) for v in vs], dim=-1)
        full = self.tp.gather(part)[:, :self.n]
        return tuple(full[..., i] for i in range(len(vs)))


def lowered_tp_memory(mesh: DeviceMesh, *operands, config=None,
                      solver: str = "box", batch_axis: str = "dp",
                      model_axis: str = "tp", device=None) -> TPMemory:
    """Per-rank memory of one tp solve, the proof that the factorization is
    partitioned and not replicated.  ``operands`` are the solver's own,
    whole, positionally (Q, p, A, b, lb, ub); trailing ``None`` may be left
    out.  ``device`` as in ``shard_problem_tp``: operands on the host and
    ``device="cuda"`` put only the rank's blocks on the card.

    ``argument_size_in_bytes``: the rank's operands (``shard_problem_tp``).
    ``temp_size_in_bytes``: on the card, ``torch.cuda.max_memory_allocated``
    over one solve less what was allocated when it began: the rank's
    operands and every other tensor the caller holds on the card (among
    them the whole operands, when they were given on the card), none of
    which this counts; on the CPU, the largest working set the
    factorization held (its operand, the sweep's matrix, one panel and the
    pivot rows)."""
    if solver != "box":
        raise NotImplementedError(_SLICE.format(f"solver={solver!r}"))
    names = ("Q", "p", "A", "b", "lb", "ub")
    if len(operands) > len(names):
        raise TypeError(f"solver 'box' takes operands {names}, got "
                        f"{len(operands)} positional arguments")
    operands = operands + (None,) * (len(names) - len(operands))
    cfg = BoxQPConfig() if config is None else config
    _check(cfg)
    Q = torch.as_tensor(operands[0])
    local = shard_problem_tp(mesh, *operands, batch_axis=batch_axis,
                             model_axis=model_axis, device=device)
    args = sum(x.nbytes for x in local if x is not None)
    tp = _TP(mesh, model_axis, Q.shape[-1])
    dev = local[0].device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with collective.batch_group(mesh_group(mesh)):
        _solve_local(tp, *local, config=cfg)
    if on_card:
        torch.cuda.synchronize(dev)
        return TPMemory(args, torch.cuda.max_memory_allocated(dev) - base)
    return TPMemory(args, tp.held)
