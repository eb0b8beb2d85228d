"""Batched safeguarded type-II Anderson acceleration (counterpart of
``lqp_py_tpu.ops.anderson``).

Per batch element, ring buffers hold the last ``m`` map outputs ``g(v_i)``
and fixed-point residuals ``r_i = g(v_i) - v_i``.  The next iterate is the
combination ``sum_i a_i g(v_i)`` with ``sum a = 1`` that minimizes the
combined residual, solved on unit-normalized residual columns through the
regularized m x m Gram matrix.  Safeguards, per element: a residual that
grows past ``safeguard`` times the best since the last reset takes the
plain step and resets the history; a combination whose weights' 1-norm
exceeds ``max_weight`` is rejected; elements flagged ``hold`` take the
plain step.  A reset fills every slot with the current pair, so the next
combination reproduces the plain step exactly.  The m x m solve is the
batch-major Gauss-Jordan inverse (``ops/linalg.py``), as plain torch ops:
the JAX package runs it as XLA ops, not in a Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from lqp_py_tpu_torch.ops.linalg import _gj_inverse_small

_TINY = 1e-16


@dataclasses.dataclass
class AAState:
    Gh: torch.Tensor    # (B, m, d) ring buffer of map outputs
    Rh: torch.Tensor    # (B, m, d) ring buffer of residuals
    rn: torch.Tensor    # (B,) best residual norm since the last reset;
    #                     -inf forces a reset on the next aa_step


def aa_init(B: int, m: int, d: int, dtype, device=None) -> AAState:
    kw = dict(dtype=dtype, device=device)
    return AAState(Gh=torch.zeros((B, m, d), **kw),
                   Rh=torch.zeros((B, m, d), **kw),
                   rn=torch.full((B,), -torch.inf, **kw))


def aa_reset_where(state: AAState, mask) -> AAState:
    """Force a history reset for masked elements on their next aa_step."""
    return dataclasses.replace(
        state, rn=torch.where(mask, -torch.inf, state.rn))


def aa_step(state: AAState, v, gv, slot: int, hold, *, safeguard: float,
            reg: float, max_weight: float):
    """One accelerated update.

    v, gv: (B, d) current iterate and its plain map output.
    slot:  ring index (the caller tracks the global iteration).
    hold:  (B,) bool — take the plain step for these elements.

    Returns ``(v_next, new_state)``.  The state's buffers are new tensors;
    the one passed in is left as it was.
    """
    Gh, Rh, rn_best = state.Gh, state.Rh, state.rn
    m = Gh.shape[1]
    dtype = Gh.dtype
    r = gv - v
    rn = torch.sqrt((r * r).sum(dim=-1))
    reset = rn > safeguard * rn_best
    rn_best = torch.where(reset, rn, torch.minimum(rn_best, rn))

    Gh = Gh.clone()
    Rh = Rh.clone()
    Gh[:, slot] = gv
    Rh[:, slot] = r
    Gh = torch.where(reset[:, None, None], gv[:, None, :], Gh)
    Rh = torch.where(reset[:, None, None], r[:, None, :], Rh)

    c = torch.sqrt((Rh * Rh).sum(dim=-1))                    # (B, m)
    cinv = 1.0 / torch.clamp(c, min=_TINY)
    Rn = Rh * cinv[..., None]
    M = Rn @ Rn.mT
    tr = M.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    # Unit-normalized columns put diag(M) at 1, so a regularizer below
    # machine eps would round away: floor it at a few ulps.
    reg_eff = max(float(reg), 16 * torch.finfo(dtype).eps)
    M = M + (reg_eff * tr / m + _TINY)[..., None, None] * torch.eye(
        m, dtype=dtype, device=M.device)
    Minv = _gj_inverse_small(M)
    y = (Minv @ cinv[..., None])[..., 0]
    w = y * cinv
    w = w / w.sum(dim=-1, keepdim=True)
    v_aa = (w[:, None, :] @ Gh)[:, 0]

    wn = w.abs().sum(dim=-1)
    accept = ((~reset) & (~hold) & (wn <= max_weight)
              & torch.isfinite(v_aa).all(dim=-1))
    v_next = torch.where(accept[:, None], v_aa, gv)
    return v_next, AAState(Gh=Gh, Rh=Rh, rn=rn_best)
