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
accumulated AL estimates.  The interior points' polish (``models/optnet.py``,
``models/box_ip.py``) runs its rounds through ``polish_rounds`` and holds
each round's point to ``accepted``, whose equality part is
``equality_excess``.

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
from lqp_py_tpu_torch.utils.profiling import span


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


#: Round 3 runs where round 2 missed the acceptance test by less than this
#: factor on both of its thresholds.
NARROW_MISS = 10.0


def acceptance_threshold(tol: float, norm):
    """The interior points' bound on a polished point's violation:
    ``tol (1 + norm)``, ``norm`` the largest |h| (or |bound|) per element."""
    return tol + tol * norm


def gen_lam_threshold(thr, dtype):
    """The sign test's threshold for ``gen_penalty_polish``'s multipliers:
    ``thr``, but no lower than their accumulation noise."""
    return torch.clamp(thr, min=al_lam_threshold(dtype))


def accepted(viol, viol_ip, thr, lam_min, thr_lam, within: float = 1.0):
    """Per element, whether a polished point is taken: it is no less
    feasible than the interior point's iterate (``viol_ip``), or within
    ``thr``, and its least multiplier is no more negative than ``-thr_lam``.
    ``within`` scales both thresholds (``NARROW_MISS``: round 3's test)."""
    return ((viol <= within * torch.maximum(viol_ip, thr))
            & (lam_min >= -within * thr_lam))


def polish_rounds(solve, repair, ok, act, fallback):
    """The interior points' active-set polish, accepted per element.

    ``solve(act, k)`` polishes the elements ``k`` (an index tensor, or
    ``slice(None)`` for all) under the whole batch's guess ``act`` and
    returns a NamedTuple whose fields are batched tensors or None;
    ``repair(act, result)`` is the next round's guess; ``ok(result, k,
    within)`` is ``accepted`` for the elements ``k``.  ``fallback``, the
    interior point's own iterate as the same NamedTuple, is kept where no
    round passes.

    Round 2 repairs round 1's guess and is preferred where both pass.  Near
    a degenerate vertex (a bound whose multiplier is ~tol) round 2's repair
    can leave a row, or a multiplier, just beyond its threshold, so a third
    round repairs once more on the elements alone that passed neither round
    and that round 2 missed by less than ``NARROW_MISS`` (one host read).
    Where it missed by more, as where the float32 penalty system of dense
    general rows breaks down, another round would not pass.  Returns the
    chosen result, field by field."""
    every = slice(None)
    pol = solve(act, every)
    act2 = repair(act, pol)
    pol2 = solve(act2, every)
    ok2 = ok(pol2, every, 1.0)
    ok1 = ok(pol, every, 1.0) & ~ok2
    out = _pick(ok2, pol2, _pick(ok1, pol, fallback))
    k = torch.nonzero(~(ok1 | ok2) & ok(pol2, every, NARROW_MISS)).flatten()
    if k.numel():
        pol3 = solve(repair(act2, pol2), k)
        ok3 = ok(pol3, k, 1.0)
        out = type(out)(*(
            None if o is None
            else o.index_copy(0, k, torch.where(ok3[..., None], r, o[k]))
            for o, r in zip(out, pol3)))
    return out


def _pick(ok, a, b):
    """Field by field, ``a``'s where ``ok`` (per element), else ``b``'s."""
    return type(b)(*(None if y is None else torch.where(ok[..., None], x, y)
                     for x, y in zip(a, b)))


def equality_excess(A, b, x, ops=DENSE):
    """Per element, the largest ``|A x - b|`` beyond its rounding:
    ``max_i |(A x - b)_i| - eps (|A| |x|)_i``.

    Row i of ``A x`` is a sum of n terms, and a point solved in the working
    precision leaves it wrong by about one ``eps`` per term: in float32 at
    n=1000 (the sum-to-one row, |x| <= 2) ~1e-4, several times the
    acceptance threshold ``tol (1 + |h|)``, while x itself is right to a
    few 1e-6.  Testing the excess keeps a correct polished point from being
    rejected for its rounding; in float64 the allowance is ~1e-13.  A wrong
    active-set guess does not move ``A x - b`` (the polish solves the
    equality rows exactly): it shows in the bound rows and the multipliers,
    which keep their thresholds."""
    r = (ops.mv(A, x) - b).abs()
    return (r - torch.finfo(x.dtype).eps
            * ops.mv(A.abs(), x.abs())).amax(dim=-1)


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

    with span("lqp.factorize"):
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
