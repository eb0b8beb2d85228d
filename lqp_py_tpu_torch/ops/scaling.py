"""Problem scaling for the box-QP ADMM solver (counterpart of
``lqp_py_tpu.ops.scaling``).

Jacobi-style diagonal scaling with a quantile-blended ``beta`` and row
equilibration of the equality constraints.  The scaled problem is

    Q' = D Q D,  p' = D p,  A' = E A D,  b' = E b,  lb' = lb / D,  ub' = ub / D

with per-batch-element diagonal vectors ``D (B, n)`` and ``E (B, m)``.
The forward solve never materializes Q' itself: ``scale_problem_h`` builds
the lane-padded factorization operand ``H = D Q D + rho I`` directly.  The
unrolled solve differentiates through the scaling (D depends on Q), so it
takes ``scale_problem``, which returns Q' and is written without in-place
writes to anything autograd tracks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def _safe_colnorm(norms):
    """Replace non-positive norms with max(mean, 1e-6) per batch element
    (the reference's zero-column clamp)."""
    fill = torch.clamp(norms.mean(dim=-1, keepdim=True), min=1e-6)
    return torch.where(norms <= 0.0, fill.expand_as(norms), norms)


class ScaledProblem(NamedTuple):
    Q: torch.Tensor
    p: torch.Tensor
    A: Optional[torch.Tensor]
    b: Optional[torch.Tensor]
    lb: torch.Tensor
    ub: torch.Tensor
    D: torch.Tensor                 # (B, n)
    E: Optional[torch.Tensor]       # (B, m) or None


def _scale_pad_q(Q, D, pad):
    """``blockdiag(D Q D, I_pad)``, differentiable in Q and D."""
    Qs = D[..., :, None] * Q * D[..., None, :]
    if pad == 0:
        return Qs
    n = Q.shape[-1]
    tail = torch.zeros(n + pad, dtype=Q.dtype, device=Q.device)
    tail[n:] = 1.0
    return F.pad(Qs, (0, pad, 0, pad)) + torch.diag(tail)


def _scaling_vector(Q, beta):
    """D from the column inf-norms of Q (``scaling_from_norms``).  ``amax``
    splits the gradient evenly among tied maxima, as ``jnp.max`` does."""
    return scaling_from_norms(Q.abs().amax(dim=-2), beta)


def scaling_from_norms(col_norms, beta):
    """D from the (B, n) column inf-norms of Q, blended toward its mean by
    beta (``None``: per element, 1 - q10(D)/q90(D)); ``torch.quantile``
    interpolates linearly, as ``jnp.quantile`` does."""
    D = torch.sqrt(1.0 / _safe_colnorm(col_norms))
    if beta is None:
        q = torch.quantile(
            D, torch.tensor([0.10, 0.90], dtype=D.dtype, device=D.device),
            dim=-1)
        beta_v = (1.0 - q[0] / q[1])[..., None]
    else:
        beta_v = torch.as_tensor(beta, dtype=D.dtype, device=D.device)
    return (1.0 - beta_v) * D + beta_v * D.mean(dim=-1, keepdim=True)


def _scale_constraints(A, b, D, pad, scale):
    """``(E A D, E b, E)`` with E the inverse row inf-norms of ``A D`` (ones
    without scaling); A gains ``pad`` zero columns."""
    AD = A * D[..., None, :]
    if scale:
        E = 1.0 / _safe_colnorm(AD.abs().amax(dim=-1))   # row inf-norms
    else:
        E = torch.ones_like(b)
    As = E[..., :, None] * AD
    if pad:
        As = F.pad(As, (0, pad))
    return As, E * b, E


def scale_problem(Q, p, A, b, lb, ub, beta=None, pad: int = 0
                  ) -> ScaledProblem:
    """Compute and apply the scaling.  All inputs in (B, n)/(B, m) layout.

    With ``pad > 0`` the returned ``Q`` is ``blockdiag(D Q D, I_pad)`` and
    ``A`` gains ``pad`` zero columns; the (B, n) outputs stay unpadded.
    Differentiable in every input."""
    D = _scaling_vector(Q, beta)
    As = bs = E = None
    if A is not None:
        As, bs, E = _scale_constraints(A, b, D, pad, True)
    # Division by D keeps +/-inf bounds infinite (D > 0).
    return ScaledProblem(Q=_scale_pad_q(Q, D, pad), p=D * p, A=As, b=bs,
                         lb=lb / D, ub=ub / D, D=D, E=E)


def identity_scaling(Q, p, A, b, lb, ub, pad: int = 0) -> ScaledProblem:
    """The unscaled problem in ``ScaledProblem`` form (D and E all ones),
    padded as ``scale_problem`` pads."""
    D = torch.ones_like(p)
    E = None if A is None else torch.ones_like(b)
    Qp = _scale_pad_q(Q, D, pad) if pad else Q
    Ap = F.pad(A, (0, pad)) if A is not None and pad else A
    return ScaledProblem(Q=Qp, p=p, A=Ap, b=b, lb=lb, ub=ub, D=D, E=E)


def _scale_pad_q_rho(Q, D, pad, rho):
    """``blockdiag(D Q D, I_pad) + rho * blockdiag(I_n, 0)``.

    The pad block is exactly the identity (rho is not added there): the
    padded coordinates stay decoupled, and a refactorization shifts only
    the leading-n diagonal."""
    B, n, _ = Q.shape
    H = Q.new_zeros((B, n + pad, n + pad))
    H[:, :n, :n] = D[..., :, None] * Q * D[..., None, :]
    diag = H.diagonal(dim1=-2, dim2=-1)
    diag[:, :n] += rho[:, None]
    diag[:, n:] = 1.0
    return H


class ScaledProblemH(NamedTuple):
    """Scaled problem with the factorization operand H pre-built."""
    H: torch.Tensor                 # (B, n+pad, n+pad) = D Q D + rho I (+pad)
    p: torch.Tensor
    A: Optional[torch.Tensor]       # (B, m, n+pad), zero pad columns
    b: Optional[torch.Tensor]
    lb: torch.Tensor
    ub: torch.Tensor
    D: torch.Tensor                 # (B, n)
    E: Optional[torch.Tensor]       # (B, m) or None


def scale_problem_h(Q, p, A, b, lb, ub, rho, beta=None, pad: int = 0,
                    scale: bool = True):
    """Compute the scaling and emit ``H = D Q D + rho I`` (lane-padded).

    ``rho`` is a callable ``rho(D, q_fro) -> (B,)`` receiving the scaling
    vector and the Frobenius norm of the scaled Q, computed as the
    quadratic form ``sqrt(d2' (Q∘Q) d2)`` with ``d2 = D*D`` (full float32
    here; the JAX package ran it at the TPU's default matmul precision).
    Returns ``(ScaledProblemH, rho_v)``."""
    D = _scaling_vector(Q, beta) if scale else torch.ones_like(p)

    d2 = D * D
    q_fro = torch.sqrt(torch.clamp(
        (((Q * Q) @ d2[..., None])[..., 0] * d2).sum(dim=-1), min=0.0))
    rho_v = rho(D, q_fro)

    H = _scale_pad_q_rho(Q, D, pad, rho_v)
    ps = D * p

    As = bs = E = None
    if A is not None:
        As, bs, E = _scale_constraints(A, b, D, pad, scale)

    # Division by D keeps +/-inf bounds infinite (D > 0).
    lbs = lb / D
    ubs = ub / D
    return ScaledProblemH(H=H, p=ps, A=As, b=bs, lb=lbs, ub=ubs, D=D,
                          E=E), rho_v
