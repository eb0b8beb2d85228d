"""Plain reference of the box QP

    min 0.5 x'Qx + p'x   s.t.  A x = b,  lb <= x <= ub   (lb, ub finite)

and of the gradient of a linear loss w'x* with respect to p and Q.

The solve is a Mehrotra predictor-corrector primal-dual interior point in
float64: slacks sl = x - lb, su = ub - x and their duals zl, zu.  Each
iteration factorizes H = Q + diag(zl/sl + zu/su) by Cholesky and
eliminates the equality rows through their Schur complement.  It shares no
algorithm with the program (an ADMM splitting with scaling and a recursive
inverse) and none of its code.

The gradient is implicit differentiation on the solution's active set: a
coordinate is active where its bound's dual exceeds its slack.  On the free
set F, [Q_FF A_F'; A_F 0] [v; mu] = [-w_F; 0], v = 0 off F; then
dL/dp = v and dL/dQ = 0.5 (v x' + x v') (the program solves with
0.5 (Q + Q')).

``tf32=True`` is the control: the same algorithm in float32 with every
matrix operand rounded to TF32 (10 explicit mantissa bits, as the tensor
cores take float32 operands) before its product or factorization.
"""

from __future__ import annotations

import dataclasses

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 ``t`` to the nearest TF32 value (ties away from zero)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@dataclasses.dataclass
class Solution:
    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    sl: torch.Tensor
    su: torch.Tensor
    iterations: int
    converged: torch.Tensor        # (B,) bool


class _Ops:
    """Products and factorizations in the reference's precision."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64

    def mat(self, M):
        M = M.to(self.dtype)
        return tf32_round(M) if self.tf32 else M

    def vec(self, v):
        return tf32_round(v) if self.tf32 else v

    def mv(self, M, v):
        return (M @ self.vec(v)[..., None])[..., 0]

    def chol(self, H):
        return torch.linalg.cholesky_ex(self.mat(H))[0]

    def kkt(self, L, A, r, rp):
        """[H A'; A 0][dx; dy] = [r; -rp] with H = L L'."""
        if A is None:
            return torch.cholesky_solve(r[..., None], L)[..., 0], None
        X = torch.cholesky_solve(torch.cat([r[..., None], A.mT], -1), L)
        x0, W = X[..., 0], X[..., 1:]
        S = A @ W
        dy = torch.linalg.solve(S, self.mv(A, x0) + rp)
        return x0 - (W @ dy[..., None])[..., 0], dy


def _step(v, dv):
    """Largest step in [0, 1] keeping v + a dv >= 0, per element."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, torch.inf))
    return torch.clamp(ratio.amin(-1), max=1.0)


def solve(Q, p, A, b, lb, ub, *, tf32: bool = False,
          max_iter: int = 80) -> Solution:
    """The interior point on (B, n) data (A (B, m, n) or None)."""
    ops = _Ops(tf32)
    dt = ops.dtype
    Q = ops.mat(Q)
    p, lb, ub = (t.to(dt) for t in (p, lb, ub))
    A = None if A is None else ops.mat(A)
    b = None if b is None else b.to(dt)
    B, n = p.shape
    # float64 stops on every residual; the TF32 control cannot drive the
    # stationarity residual below its products' rounding, so it stops on
    # the complementarity gap alone.
    tol = 1e-7 if tf32 else 1e-11
    x = 0.5 * (lb + ub)
    sl, su = x - lb, ub - x
    zl, zu = torch.ones_like(x), torch.ones_like(x)
    y = torch.zeros((B, 0 if A is None else A.shape[1]), dtype=dt,
                    device=x.device)
    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    scale = 1.0 + p.abs().amax(-1)
    it = 0
    for it in range(1, max_iter + 1):
        rd = ops.mv(Q, x) + p - zl + zu
        if A is not None:
            rd = rd + ops.mv(A.mT, y)
            rp = ops.mv(A, x) - b
        else:
            rp = None
        mu = (sl * zl + su * zu).sum(-1) / (2 * n)
        res = mu
        if not tf32:
            res = torch.maximum(res, rd.abs().amax(-1) / scale)
            if rp is not None:
                res = torch.maximum(res, rp.abs().amax(-1))
        done = done | (res < tol)
        if bool(done.all()):
            break
        Lh = ops.chol(Q + torch.diag_embed(zl / sl + zu / su))

        def direction(cl, cu):
            dx, dy = ops.kkt(Lh, A, -rd + cl / sl - cu / su,
                             None if rp is None else rp)
            return dx, dy, (cl - zl * dx) / sl, (cu + zu * dx) / su

        # Predictor (affine scaling), then Mehrotra's corrector.
        dx, dy, dzl, dzu = direction(-sl * zl, -su * zu)
        ap = torch.minimum(_step(sl, dx), _step(su, -dx))[:, None]
        ad = torch.minimum(_step(zl, dzl), _step(zu, dzu))[:, None]
        mu_aff = ((sl + ap * dx) * (zl + ad * dzl)
                  + (su - ap * dx) * (zu + ad * dzu)).sum(-1) / (2 * n)
        sm = ((mu_aff / mu) ** 3 * mu)[:, None]
        dx, dy, dzl, dzu = direction(sm - sl * zl - dx * dzl,
                                     sm - su * zu + dx * dzu)
        ap = (0.995 * torch.minimum(_step(sl, dx), _step(su, -dx))
              ).clamp(max=1.0)[:, None]
        ad = (0.995 * torch.minimum(_step(zl, dzl), _step(zu, dzu))
              ).clamp(max=1.0)[:, None]
        # An element whose factorization broke down keeps its last iterate.
        done = done | ~torch.isfinite(dx).all(-1) | ~torch.isfinite(
            dzl + dzu).all(-1)
        go = (~done)[:, None]
        x = torch.where(go, x + ap * dx, x)
        sl = torch.where(go, sl + ap * dx, sl)
        su = torch.where(go, su - ap * dx, su)
        zl = torch.where(go, zl + ad * dzl, zl)
        zu = torch.where(go, zu + ad * dzu, zu)
        if dy is not None:
            y = torch.where(go, y + ad * dy, y)
    return Solution(x, y, zl, zu, sl, su, it, done)


def active(sol: Solution) -> torch.Tensor:
    """(B, n) bool: the coordinates at a bound."""
    return (sol.zl > sol.sl) | (sol.zu > sol.su)


def margin(sol: Solution) -> torch.Tensor:
    """(B,) the least strict-complementarity margin of each element: the
    dual of an active bound, or the distance of a free coordinate to its
    nearer bound.  Where it is near 0 the active set, and with it the
    gradient, is not determined by the problem at the solver's tolerance."""
    act = active(sol)
    return torch.where(act, torch.maximum(sol.zl, sol.zu),
                       torch.minimum(sol.sl, sol.su)).amin(-1)


def grad_p(Q, A, sol: Solution, w, *, tf32: bool = False) -> torch.Tensor:
    """dL/dp for L = w'x* (B, n); dL/dQ is ``grad_q(v, x)`` of it."""
    ops = _Ops(tf32)
    dt = ops.dtype
    keep = (~active(sol)).to(dt)
    H = keep[:, :, None] * ops.mat(Q) * keep[:, None, :]
    H.diagonal(dim1=-2, dim2=-1).add_(1.0 - keep)
    Am = None if A is None else ops.mat(A) * keep[:, None, :]
    v, _ = ops.kkt(ops.chol(H), Am, -keep * w.to(dt),
                   None if A is None else torch.zeros(
                       A.shape[:2], dtype=dt, device=w.device))
    return v


def grad_q(v, x) -> torch.Tensor:
    """0.5 (v x' + x v')."""
    half = 0.5 * v[..., :, None] * x[..., None, :]
    return half + half.mT
