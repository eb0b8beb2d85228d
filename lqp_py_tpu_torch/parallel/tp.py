"""Tensor-parallel ('tp') column sharding of every solver family
(counterpart of ``lqp_py_tpu.parallel.tp``): the box ADMM, the
general-inequality splitting solver, OptNet and the box-structured
interior point.

The batch axis ('dp') is embarrassingly parallel; 'tp' is for the other
direction, a problem whose n makes the (B, n, n) operators too large for
one card.  Each (dp, tp) rank holds its batch shard and the block of its
columns of every matrix with n columns (Q, A, G and the inverses factored
from them); vectors are replicated over 'tp'.  The JAX package gets the
partitioned solves from GSPMD; here every collective is placed by hand
(``tp_ops.py``: the rank's collectives, ``column_spd_inverse`` and the
``Columns`` operator).

- **The box ADMM** keeps its padded (B, N, L) block of ``H = D Q D + rho
  I`` (``_ColumnKKT``, the loop's KKT operator): Q's column norms are
  gathered, the auto-rho ``||D Q D||_F`` is a partial sum and A's row
  norms a partial maximum, each plus an all-reduce; ``Hinv`` stays
  column-sharded, and ``W = Hinv A^T``, ``S = A W`` are partial products
  plus an all-reduce.  The x-update ``Hinv r`` is the local product plus
  one all-reduce per iteration.  The early-exit step
  (``use_pallas_step``) materializes the rank's block of ``P = Hinv - WS
  W^T``, runs the early-exit GEMV kernel on it against r's rows of its
  columns (frozen elements write zeros), all-reduces, and keeps a frozen
  element's x bitwise.  Anderson acceleration acts on the replicated
  ``[z; u]`` and needs no collective; its Gram inverse is the same on
  every rank.  The polish goes through ``Columns``.  In Cholesky mode
  (``kkt_solver="cholesky"``) the rank keeps its columns of ``L =
  chol(H)`` (``column_cholesky``) and applies ``H^-1`` by the two
  distributed triangular sweeps, 2t - 1 broadcasts of (B, N) per
  iteration; ``W = H^-1 A^T`` comes from the same sweeps, and the
  early-exit step is off, as in one process.
- **GenQP, OptNet and the box IP** run their own loops
  (``models/genqp.py``, ``models/optnet.py``, ``models/box_ip.py``) with
  ``Columns`` as their operator: G's products are partial sums, the Gram
  ``G^T diag(w) G`` is a block exchange, and every factorization is
  ``column_spd_inverse``.  OptNet's Schur mode keeps ``Qinv``
  column-sharded; ``Qinv G^T``, R and the ni x ni pieces are whole.
  Without G, OptNet is the equality-constrained solve on the rank's
  columns (``Columns.factorize`` and ``kkt_apply``), as in one process.

Each check's flags are all-reduced over every rank of the mesh (dp x tp,
``mesh_group``), so the tp ranks leave a loop together even if their
replicated vectors ever differed.  The result matches the single-process
solve to the solve's tolerance, not bitwise (other summation orders,
another factorization).

A rank needs only its own blocks: each ``*_local`` entry takes them
(``shard_problem_tp`` cuts them from a whole problem, which may stay on the
host, or a caller builds them from ``tp_columns``), so no operator lies
whole on any card.  The other entries take the whole problem, as the JAX
functions do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from lqp_py_tpu_torch.config import BoxQPConfig, GenQPConfig, OptNetConfig
from lqp_py_tpu_torch.models import box_ip, box_qp, genqp, optnet
from lqp_py_tpu_torch.ops import collective
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops import scaling as sca
from lqp_py_tpu_torch.ops.kernels import admm_step
from lqp_py_tpu_torch.ops.precision import solver_precision
from lqp_py_tpu_torch.parallel.mesh import mesh_group, shard_batch
from lqp_py_tpu_torch.parallel.tp_ops import (_TP, Columns, column_blocks,
                                              column_chol_solve,
                                              column_cholesky)
from lqp_py_tpu_torch.types import QPSolution, as_vector
from lqp_py_tpu_torch.utils.profiling import span

_BOX = ("Q", "p", "A", "b", "lb", "ub")
_GEN = ("Q", "p", "A", "b", "G", "h")


class TPMemory(NamedTuple):
    """Per-rank bytes of one tp solve (``lowered_tp_memory``)."""
    argument_size_in_bytes: int
    temp_size_in_bytes: int


def tp_columns(mesh: DeviceMesh, n: int, model_axis: str = "tp") -> slice:
    """The columns of Q, A and G (of n) that this rank holds over
    ``model_axis``: ``[c L, min((c+1) L, n))`` (``column_blocks``)."""
    t = mesh.shape[mesh.mesh_dim_names.index(model_axis)]
    L, _ = column_blocks(n, t)
    c = mesh.get_local_rank(model_axis)
    return slice(min(c * L, n), min((c + 1) * L, n))


def shard_problem_tp(mesh: DeviceMesh, *operands, solver: str = "box",
                     batch_axis: str = "dp", model_axis: str = "tp",
                     device=None):
    """The rank's part of a problem given as ``solver``'s operands, in its
    positional order ('box', 'box_ip': Q, p, A, b, lb, ub; 'genqp',
    'optnet': Q, p, A, b, G, h): the batch shard over ``batch_axis``, and
    of every matrix the column block over ``model_axis`` (``tp_columns``;
    a copy of its own); vectors whole over ``model_axis``, the ``(B, n,
    1)`` layout brought to ``(B, n)``.  Matrices are told apart from
    vectors by their position, never their shape (n = 1 makes a matrix
    (B, k, 1)).  ``device``: where the parts go (default: where the
    operands are), so that a whole problem kept on the host puts only its
    blocks on a card."""
    _, _, mats, _ = _spec(solver, operands)
    cols = tp_columns(mesh, torch.as_tensor(operands[0]).shape[-1],
                      model_axis)

    def place(i, x):
        if x is None:
            return None
        x = shard_batch(torch.as_tensor(x), mesh, batch_axis)
        if i in mats:
            x = x[..., cols]
        elif x.ndim == 3 and x.shape[-1] == 1:     # (B, n, 1) layout
            x = x[..., 0]
        return x.contiguous().to(device)

    return tuple(place(i, x) for i, x in enumerate(operands))


def _solve(solver, mesh, operands, config, batch_axis, model_axis):
    return _solve_local(solver, mesh, shard_problem_tp(
        mesh, *operands, solver=solver, batch_axis=batch_axis,
        model_axis=model_axis), config, model_axis)


def _solve_local(solver, mesh, local, config, model_axis):
    tp = _TP(mesh, model_axis, as_vector(local[1], "p").shape[-1])
    with collective.batch_group(mesh_group(mesh)):
        return _TP_SOLVERS[solver][0](tp, *local, config=config)


def solve_box_qp_tp(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None,
                    ub=None, config: BoxQPConfig = BoxQPConfig(),
                    batch_axis: str = "dp", model_axis: str = "tp"):
    """Forward box-QP solve with the KKT operator column-sharded over
    ``model_axis`` and the batch over ``batch_axis``: the algorithm of
    ``solve_box_qp`` (either KKT mode, with polish, Anderson and the
    early-exit step), the layout of ``shard_problem_tp``.  Takes the whole
    problem on every rank (where a whole Q does not fit,
    ``solve_box_qp_tp_local`` takes the rank's blocks); returns the rank's
    batch shard of the ``BoxQPSolution``, whole over ``model_axis``."""
    return _solve("box", mesh, (Q, p, A, b, lb, ub), config, batch_axis,
                  model_axis)


def solve_box_qp_tp_local(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None,
                          ub=None, config: BoxQPConfig = BoxQPConfig(),
                          batch_axis: str = "dp", model_axis: str = "tp"):
    """``solve_box_qp_tp`` on the rank's own part of the problem, as
    ``shard_problem_tp`` gives it: Q (B_loc, n, k) and A (B_loc, m, k) the
    rank's ``tp_columns``, the vectors (B_loc, n) whole.  No rank needs
    more of Q than its block."""
    return _solve_local("box", mesh, (Q, p, A, b, lb, ub), config,
                        model_axis)


def solve_qp_gen_tp(mesh: DeviceMesh, Q, p, A=None, b=None, G=None, h=None,
                    config: GenQPConfig = GenQPConfig(),
                    batch_axis: str = "dp", model_axis: str = "tp"):
    """General-inequality splitting solve (``solve_qp_gen``) with Q, A and
    G column-sharded over ``model_axis``: the x-step factorization is
    ``column_spd_inverse`` of the rank's block of ``Qs + rho Gs^T Gs +
    sigma I``, the loop's G products partial sums."""
    return _solve("genqp", mesh, (Q, p, A, b, G, h), config, batch_axis,
                  model_axis)


def solve_qp_gen_tp_local(mesh: DeviceMesh, Q, p, A=None, b=None, G=None,
                          h=None, config: GenQPConfig = GenQPConfig(),
                          batch_axis: str = "dp", model_axis: str = "tp"):
    """``solve_qp_gen_tp`` on the rank's blocks (``shard_problem_tp(...,
    solver="genqp")``): Q, A and G of its ``tp_columns``."""
    return _solve_local("genqp", mesh, (Q, p, A, b, G, h), config,
                        model_axis)


def solve_qp_optnet_tp(mesh: DeviceMesh, Q, p, A=None, b=None, G=None,
                       h=None, config: OptNetConfig = OptNetConfig(),
                       batch_axis: str = "dp", model_axis: str = "tp"):
    """Interior-point solve (``solve_qp_optnet``, Schur or condensed) with
    Q, A and G column-sharded over ``model_axis``; without G the
    equality-constrained (or, without A too, unconstrained) solve."""
    return _solve("optnet", mesh, (Q, p, A, b, G, h), config, batch_axis,
                  model_axis)


def solve_qp_optnet_tp_local(mesh: DeviceMesh, Q, p, A=None, b=None,
                             G=None, h=None,
                             config: OptNetConfig = OptNetConfig(),
                             batch_axis: str = "dp",
                             model_axis: str = "tp"):
    """``solve_qp_optnet_tp`` on the rank's blocks."""
    return _solve_local("optnet", mesh, (Q, p, A, b, G, h), config,
                        model_axis)


def solve_box_qp_ip_tp(mesh: DeviceMesh, Q, p, A=None, b=None, lb=None,
                       ub=None, config: OptNetConfig = OptNetConfig(),
                       batch_axis: str = "dp", model_axis: str = "tp"):
    """Box-structured interior-point solve (``solve_box_qp_ip``) with Q and
    A column-sharded over ``model_axis``: each iteration factors the
    rank's block of ``Q + diag(d)``."""
    return _solve("box_ip", mesh, (Q, p, A, b, lb, ub), config, batch_axis,
                  model_axis)


def solve_box_qp_ip_tp_local(mesh: DeviceMesh, Q, p, A=None, b=None,
                             lb=None, ub=None,
                             config: OptNetConfig = OptNetConfig(),
                             batch_axis: str = "dp",
                             model_axis: str = "tp"):
    """``solve_box_qp_ip_tp`` on the rank's blocks."""
    return _solve_local("box_ip", mesh, (Q, p, A, b, lb, ub), config,
                        model_axis)


@solver_precision
def _box_local(tp: _TP, Q, p, A, b, lb, ub, config):
    """The box ADMM on the rank's part (``shard_problem_tp``)."""
    kw = dict(dtype=Q.dtype, device=Q.device)
    n, ops = tp.n, Columns(tp)
    p = as_vector(p, "p").to(**kw)
    b = None if b is None else as_vector(b, "b").to(**kw)
    A = None if A is None else A.to(**kw)
    B = p.shape[0]
    lb = (torch.full((B, n), -math.inf, **kw) if lb is None
          else as_vector(lb, "lb").to(**kw))
    ub = (torch.full((B, n), math.inf, **kw) if ub is None
          else as_vector(ub, "ub").to(**kw))
    if config.symmetrize:
        Q = ops.symmetrize(Q)

    p_norm = box_qp._inf_norm(p)
    if config.scale:
        D = sca.scaling_from_norms(ops.col_absmax(Q), config.beta)
    else:
        D = torch.ones_like(p)
    d2 = D * D
    q_fro = torch.sqrt(torch.clamp(ops.sum(
        (lin._mv(Q * Q, ops.cols(d2)) * d2).sum(dim=-1)), min=0.0))
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
        AD = A * ops.cols(D)[:, None, :]
        if config.scale:
            E = 1.0 / sca._safe_colnorm(ops.row_absmax(AD))
        else:
            E = torch.ones_like(b)
        As = F.pad(E[..., None] * AD, (0, tp.L - AD.shape[-1]))
        bs = E * b
    mode = box_qp._mode(config)
    kkt = _ColumnKKT(H, As, bs, rho0, tp, mode, equilibrate=not config.scale,
                     use_pallas=(bool(config.use_pallas_step)
                                 and mode == "inverse"))
    return box_qp._solve_scaled(config, D * p, As, bs, lb / D, ub / D, D, E,
                                p_norm, rho0, None, None, H0=H, kkt=kkt)


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


class _ColumnKKT:
    """``models/box_qp._KKTOperator`` on the rank's column block ``H0``
    (B, N, L) and ``As`` (B, m, L) of the padded operator, through the
    padded ``Columns``.  Inverse mode: ``W = Hinv A^T`` and ``S = A W``
    are its partial products, the rank's block of ``P = Hinv - WS W^T`` is
    local.  Cholesky mode: the rank's block of ``L = chol(H)``, and ``W``
    (whole) by the triangular sweeps on the gathered ``A^T``."""

    def __init__(self, H0, As, bs, rho0, tp: _TP, mode: str,
                 equilibrate: bool, use_pallas: bool):
        self.H0, self.As, self.bs, self.rho0 = H0, As, bs, rho0
        self.tp, self.mode = tp, mode
        self.ops = Columns(tp, padded=True, equilibrate=equilibrate)
        self.n, self.n_pad = tp.n, tp.N
        self.use_pallas = use_pallas

    def factorize(self, rho=None) -> lin.KKTFactors:
        with span("lqp.factorize"):
            H = self.H0
            if rho is not None:
                # The unpadded diagonal only, as the whole-operator solve.
                shift = F.pad((rho - self.rho0)[:, None].expand(-1, self.n),
                              (0, self.n_pad - self.n))
                H = self.ops.add_diag(H.clone(), shift)
            if self.mode == "inverse":
                return self.ops.factorize(H, self.As,
                                          materialize_p=self.use_pallas)
            Lc = column_cholesky(H, self.tp)
            if self.As is None:
                return lin.KKTFactors(L=Lc)
            W = column_chol_solve(Lc, self.tp.gather(self.As.mT),
                                  self.tp)
            return lin.KKTFactors(L=Lc, W=W, Sinv=lin.schur_inverse(
                self.ops.mm(self.As, W)))

    def step_constant(self, f: lin.KKTFactors):
        """``q`` of the x-update; 0 in Cholesky mode, whose x-update takes
        the whole KKT solve, as in one process."""
        if f.W is None or f.L is not None:
            return self.rho0.new_zeros((self.rho0.shape[0], self.n_pad))
        return lin._mv(f.W, lin._mv(f.Sinv, self.bs))

    def x_update(self, f: lin.KKTFactors, q, r):
        if f.L is not None:
            y = column_chol_solve(f.L, r, self.tp)
            if f.W is None:
                return y
            return y - lin._mv(f.W, lin._mv(f.Sinv,
                                            lin._mv(f.W.mT, r) - self.bs))
        y = self.ops.mv(f.Hinv, r)
        if f.W is not None:
            y = y - lin._mv(f.WS, lin._mv(f.W.mT, r))
        return y + q

    def gemv(self, P, r, x, converged):
        """The early-exit step's ``P r`` from the rank's (B, N, L) block of
        P: the kernel against r's rows of the rank's columns, with frozen
        elements writing zeros, one all-reduce, and a frozen element's x
        kept bitwise."""
        part = admm_step.gemv_early_exit(P, self.ops.cols(r),
                                         torch.zeros_like(x), converged)
        return torch.where(converged[:, None], x, self.tp.sum(part))

    def at_mv(self, *vs):
        part = torch.stack([lin._mv(self.As.mT, v) for v in vs], dim=-1)
        full = self.tp.gather(part)[:, :self.n]
        return tuple(full[..., i] for i in range(len(vs)))

    def polish_operands(self):
        """``_KKTOperator.polish_operands`` on the rank's columns: Q rebuilt
        from ``H0`` as the one-process solve does it, and ``Columns``."""
        ops = Columns(self.tp)
        k = ops.k.stop - ops.k.start
        Qs = ops.add_diag(self.H0[:, :self.n, :k].clone(),
                          -self.rho0[:, None])
        return ops, Qs, None if self.As is None else self.As[:, :, :k]


@solver_precision
def _gen_local(tp: _TP, Q, p, A, b, G, h, config):
    ops = Columns(tp)
    prep = genqp._gen_prepare(Q, A, b, G, h, config, ops)
    return genqp._solve_gen_scaled(config, prep, *genqp._p_scaled(prep, p),
                                   None, ops)


def _optnet_local(tp: _TP, Q, p, A, b, G, h, config):
    ops = Columns(tp)
    if G is None:
        return _eq_local(ops, Q, p, A, b)
    return optnet._solve_qp_optnet_full(Q, p, A, b, G, h, config, ops)[0]


@solver_precision
def _eq_local(ops: Columns, Q, p, A, b):
    """OptNet without G on the rank's columns, as ``_solve_qp_optnet_full``
    reduces it: the equality-constrained solve (``Columns.factorize`` and
    ``kkt_apply``), or without A ``Q^-1 (-p)``; no inequality, no
    iteration, every element converged."""
    Q = ops.symmetrize(Q)
    kw = dict(dtype=Q.dtype, device=Q.device)
    p = as_vector(p, "p").to(**kw)
    B = p.shape[0]
    if A is None:
        x, nus = ops.mv(ops.inverse(Q), -p), None
    else:
        x, nus = ops.kkt_apply(ops.factorize(Q, A.to(**kw)), -p,
                               as_vector(b, "b").to(**kw))
    zeros = torch.zeros((B,), **kw)
    return QPSolution(x=x, lams=torch.zeros((B, 0), **kw),
                      slacks=torch.zeros((B, 0), **kw), nus=nus,
                      iterations=0, primal_residual=zeros,
                      dual_residual=zeros,
                      converged=torch.ones((B,), dtype=torch.bool,
                                           device=Q.device))


@solver_precision
def _box_ip_local(tp: _TP, Q, p, A, b, lb, ub, config):
    return box_ip._solve_box_ip(Columns(tp), Q, p, A, b, lb, ub, config)


# solver -> (the solve on the rank's part, default config, matrix operand
# slots, operand names): the JAX package's ``_TP_SOLVERS`` order.
_TP_SOLVERS = {
    "box": (_box_local, BoxQPConfig, (0, 2), _BOX),
    "genqp": (_gen_local, GenQPConfig, (0, 2, 4), _GEN),
    "optnet": (_optnet_local, OptNetConfig, (0, 2, 4), _GEN),
    "box_ip": (_box_ip_local, OptNetConfig, (0, 2), _BOX),
}


def _spec(solver, operands):
    if solver not in _TP_SOLVERS:
        raise ValueError(f"unknown tp solver {solver!r}; one of "
                         f"{sorted(_TP_SOLVERS)}")
    spec = _TP_SOLVERS[solver]
    if len(operands) > len(spec[3]):
        raise TypeError(f"solver {solver!r} takes operands {spec[3]}, got "
                        f"{len(operands)} positional arguments")
    return spec


def lowered_tp_memory(mesh: DeviceMesh, *operands, config=None,
                      solver: str = "box", batch_axis: str = "dp",
                      model_axis: str = "tp", device=None) -> TPMemory:
    """Per-rank memory of one tp solve, the proof that the factorization is
    partitioned and not replicated.  ``operands`` are the solver's own,
    whole, in its positional order ('box'/'box_ip': Q, p, A, b, lb, ub;
    'genqp'/'optnet': Q, p, A, b, G, h); trailing ``None`` may be left
    out.  ``device`` as in ``shard_problem_tp``: operands on the host and
    ``device="cuda"`` put only the rank's blocks on the card.

    ``argument_size_in_bytes``: the rank's operands (``shard_problem_tp``).
    ``temp_size_in_bytes``: on the card, ``torch.cuda.max_memory_allocated``
    over one solve less what was allocated when it began: the rank's
    operands and every other tensor the caller holds on the card (among
    them the whole operands, when they were given on the card), none of
    which this counts; on the CPU, the largest working set a factorization
    held (its operand, the sweep's matrix, one panel and the pivot rows)
    plus the largest G block a Gram exchange received."""
    _, default, _, names = _spec(solver, operands)
    operands = operands + (None,) * (len(names) - len(operands))
    cfg = default() if config is None else config
    local = shard_problem_tp(mesh, *operands, solver=solver,
                             batch_axis=batch_axis, model_axis=model_axis,
                             device=device)
    args = sum(x.nbytes for x in local if x is not None)
    tp = _TP(mesh, model_axis, torch.as_tensor(operands[0]).shape[-1])
    dev = local[0].device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with collective.batch_group(mesh_group(mesh)):
        _TP_SOLVERS[solver][0](tp, *local, config=cfg)
    if on_card:
        torch.cuda.synchronize(dev)
        return TPMemory(args, torch.cuda.max_memory_allocated(dev) - base)
    return TPMemory(args, tp.held + tp.received)
