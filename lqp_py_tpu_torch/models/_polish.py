"""Active-set penalty polish shared by the box solvers (counterpart of
``lqp_py_tpu.models._polish``).

Given a guessed active set, re-solve the QP with the active bounds
enforced by a quadratic penalty (w = 1e3 in float32, 1e6 in float64) and
augmented-Lagrangian multiplier updates, each pass refined twice through
the full reduced KKT system.  The penalty keeps every element's system SPD
and of one shape, so one batched ``spd_inverse_fast`` factorization (the
SWEEP leaf on the card, equilibrated) serves the whole batch although the
active sets differ.

``box_penalty_polish`` returns unclipped multipliers read off the
stationarity identity: a negative one means the guess was wrong for that
coordinate, and the caller then keeps its own iterate.
``gen_penalty_polish`` pins rows of ``G x <= h`` and returns the
accumulated AL estimates.

Both take an ``ops`` operator (``ops/operator.py``): the one-process solve
holds Q, A and G whole (``DENSE``), a column-sharded solve passes the rank's
column blocks and ``parallel/tp_ops.Columns``.  The refinement arithmetic
is the same code for both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lqp_py_tpu_torch.ops.linalg import _mv
from lqp_py_tpu_torch.ops.operator import DENSE


class PolishResult(NamedTuple):
    x: torch.Tensor
    y: Optional[torch.Tensor]   # equality dual (None when A is None)
    lam_lo: torch.Tensor        # unclipped; negative => wrong active guess
    lam_hi: torch.Tensor


def _penalty_weight(dtype) -> float:
    # The AL updates remove the lam/w bias, so w need not be large; a
    # lower w keeps the update's rounding noise w*eps small (1e-4 in
    # float32).
    return 1e3 if dtype == torch.float32 else 1e6


def al_lam_threshold(dtype) -> float:
    """Sign-test threshold for AL-estimated multipliers
    (``gen_penalty_polish``): the accumulation carries absolute rounding
    noise of about w * eps per pass."""
    return 4.0 * _penalty_weight(dtype) * torch.finfo(dtype).eps


def _refined_solve(ops, residual, Hinv, A, b, W, Sinv, rhs):
    """x (and y) of ``[[H, A^T], [A, 0]] [x; y] = [rhs; b]`` through
    ``Hinv`` and the Schur pieces, then two full-KKT refinement passes;
    ``residual(rhs, x)`` is ``rhs - H x`` with the exact H."""
    if A is None:
        x, y = ops.mv(Hinv, rhs), None
    else:
        t = ops.mv(Hinv, rhs)
        y = _mv(Sinv, ops.mv(A, t) - b)
        x = t - _mv(W, y)
    for _ in range(2):
        resid_x = residual(rhs, x)
        if A is None:
            x = x + ops.mv(Hinv, resid_x)
        else:
            resid_x = resid_x - ops.mtv(A, y)
            resid_b = b - ops.mv(A, x)
            t = ops.mv(Hinv, resid_x)
            dy = _mv(Sinv, ops.mv(A, t) - resid_b)
            x = x + t - _mv(W, dy)
            y = y + dy
    return x, y


def box_penalty_polish(Q, p, A, b, lb, ub, act_lo, act_hi,
                       refine_steps: int = 3, ops=DENSE) -> PolishResult:
    """Penalty-pinned re-solve of ``min 1/2 x'Qx + p'x, Ax = b`` with the
    ``act_lo``/``act_hi`` coordinates pulled onto their bound.

    ``lb``/``ub`` may be infinite off the active sets (masked out before
    any multiply).  Q and A as ``ops`` holds them (whole by default)."""
    w = _penalty_weight(Q.dtype)
    zero = torch.zeros((), dtype=Q.dtype, device=Q.device)
    w_lo = torch.where(act_lo, w, zero)
    w_hi = torch.where(act_hi, w, zero)
    lb_act = torch.where(act_lo, lb, zero)
    ub_act = torch.where(act_hi, ub, zero)
    w_d = w_lo + w_hi

    Hinv = ops.inverse(ops.add_diag(Q.clone(), w_d))
    W = Sinv = None
    if A is not None:
        W, Sinv = ops.schur(Hinv, A)

    def residual(rhs, x):
        return rhs - ops.mv(Q, x) - w_d * x

    l_lo = torch.zeros_like(p)
    l_hi = torch.zeros_like(p)
    x = y = None
    for _ in range(max(refine_steps, 1)):
        rhs = -p + w_lo * lb_act + w_hi * ub_act + l_lo - l_hi
        x, y = _refined_solve(ops, residual, Hinv, A, b, W, Sinv, rhs)
        l_lo = l_lo + w_lo * (lb_act - x)
        l_hi = l_hi + w_hi * (x - ub_act)

    # Multipliers read off stationarity at the polished point
    # (lam_lo - lam_hi = Qx + p + A'y on the active set).  A pin (active
    # on both sides) takes either sign, split by relu.
    s = ops.mv(Q, x) + p
    if A is not None:
        s = s + ops.mtv(A, y)
    both = act_lo & act_hi
    zv = torch.zeros_like(p)
    lam_lo = torch.where(act_lo, torch.where(both, torch.clamp(s, min=0.0),
                                             s), zv)
    lam_hi = torch.where(act_hi, torch.where(both, torch.clamp(-s, min=0.0),
                                             -s), zv)
    return PolishResult(x=x, y=y, lam_lo=lam_lo, lam_hi=lam_hi)


class GenPolishResult(NamedTuple):
    x: torch.Tensor
    y: Optional[torch.Tensor]   # equality dual (None when A is None)
    lam: torch.Tensor           # AL multipliers; negative => wrong guess


def gen_penalty_polish(Q, p, A, b, G, h, act,
                       refine_steps: int = 3, ops=DENSE) -> GenPolishResult:
    """General-inequality variant: pin the ``act`` rows of ``G x <= h`` as
    equalities by penalty (``H = Q + w G_act' G_act``) and AL updates.
    The returned ``lam`` is the accumulated AL estimate, accurate to about
    w * eps and negative on rows where the guess was wrong.  Q, A and G as
    ``ops`` holds them."""
    w = _penalty_weight(Q.dtype)
    zero = torch.zeros((), dtype=Q.dtype, device=Q.device)
    wa = torch.where(act, w, zero)                        # (B, m)
    h_act = torch.where(act, h, zero)

    Hinv = ops.inverse(Q + ops.gram(G * wa[..., :, None], G))
    W = Sinv = None
    if A is not None:
        W, Sinv = ops.schur(Hinv, A)

    def residual(rhs, x):
        return rhs - ops.mv(Q, x) - ops.mtv(G, wa * ops.mv(G, x))

    lam = torch.zeros_like(h)
    x = y = None
    for _ in range(max(refine_steps, 1)):
        # Stationarity of the AL subproblem:
        # Qx + p + A'y + G'[act * (l + w (Gx - h))] = 0.
        rhs = -p + ops.mtv(G, wa * h_act - torch.where(act, lam, zero))
        x, y = _refined_solve(ops, residual, Hinv, A, b, W, Sinv, rhs)
        lam = lam + wa * (ops.mv(G, x) - h_act)
    return GenPolishResult(x=x, y=y, lam=torch.where(act, lam, zero))
