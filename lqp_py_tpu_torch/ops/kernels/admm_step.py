"""ADMM x-update GEMV with per-element early exit (counterpart of
``lqp_py_tpu.ops.pallas.admm_step``).

``gemv_early_exit`` computes ``x[b] = P[b] @ r[b]`` for elements that have
not converged and returns ``x_prev[b]`` bitwise for those that have.  P is
(B, m, n): square in the one-process solve, the rank's column block of P in
the column-sharded one (``parallel/tp.py``).  On a
CUDA tensor it launches the hand-written kernel
(``csrc/gemv_early_exit.cu``), which never reads a converged element's P
panel; on a CPU tensor it runs the plain version, ``gemv_early_exit_ref``,
which reads all of P.  ``fused_admm_step`` wraps it with the z/u/r updates
as plain elementwise torch, frozen with ``where`` wherever converged, as the
JAX package leaves them to XLA; the x-update's GEMV is a parameter, so that
the column-sharded solve supplies its own (the kernel on its block plus an
all-reduce).
"""

from __future__ import annotations

import torch

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0


def gemv_early_exit_ref(P, r, x_prev, converged):
    """Plain PyTorch version: one batched GEMV over all of P, then the
    converged elements' rows replaced by ``x_prev``."""
    return torch.where(converged[:, None], x_prev, (P @ r[..., None])[..., 0])


def gemv_early_exit(P, r, x_prev, converged):
    """``x[b] = P[b] @ r[b]`` where ``converged[b]`` is False, ``x_prev[b]``
    (bitwise) where it is True.

    P (B, m, n); r (B, n); x_prev (B, m); converged (B,) bool.  A CPU
    tensor takes the plain version.  A CUDA tensor always goes to the
    kernel, which takes float32 with P contiguous (r and x_prev are made
    contiguous here) and any m and n; anything else raises."""
    global LAUNCHES
    if P.device.type == "cpu":
        return gemv_early_exit_ref(P, r, x_prev, converged)
    if P.device.type != "cuda":
        raise ValueError(f"gemv_early_exit: unsupported device {P.device}")
    if (P.ndim != 3 or r.ndim != 2 or P.shape[0] != r.shape[0]
            or P.shape[2] != r.shape[1] or x_prev.shape != P.shape[:2]
            or converged.shape != r.shape[:1]):
        raise ValueError(
            f"gemv_early_exit takes P (B, m, n), r (B, n), x_prev (B, m), "
            f"converged (B,); got {tuple(P.shape)}, {tuple(r.shape)}, "
            f"{tuple(x_prev.shape)}, {tuple(converged.shape)}")
    if any(t.dtype != torch.float32 for t in (P, r, x_prev)):
        raise ValueError(
            f"gemv_early_exit kernel takes float32, got {P.dtype}, "
            f"{r.dtype}, {x_prev.dtype}")
    if converged.dtype != torch.bool:
        raise ValueError(f"converged must be bool, got {converged.dtype}")
    if any(t.device != P.device for t in (r, x_prev, converged)):
        raise ValueError("gemv_early_exit: operands on different devices")
    if not P.is_contiguous():
        raise ValueError("gemv_early_exit kernel needs a contiguous P")
    from lqp_py_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    r = r.contiguous()
    x_prev = x_prev.contiguous()
    flags = converged.contiguous().view(torch.uint8)
    out = torch.empty_like(x_prev)
    B, m, n = P.shape
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        rc = lib.gemv_early_exit_rect_f32(P.data_ptr(), r.data_ptr(),
                                          x_prev.data_ptr(), flags.data_ptr(),
                                          out.data_ptr(), B, m, n, stream)
    if rc != 0:
        raise RuntimeError(f"gemv_early_exit kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return out


def fused_admm_step(P, r, x, z, u, p, q, lb, ub, rho, converged,
                    alpha: float = 1.0, gemv=None):
    """One ADMM iteration with per-element early exit: the x-update GEMV
    skips converged elements' P panels; the elementwise z/u/r updates
    freeze them with ``where``.

    All vectors (B, n), P (B, n, n), rho (B,), converged (B,) bool.
    ``alpha`` is a static over-relaxation factor: unlike the lock-step loop
    it does not collapse to 1 when no bound is finite.  ``gemv(P, r, x,
    converged)`` is the x-update's product (``gemv_early_exit`` by default;
    the column-sharded solve passes its own, P then its block).  Returns
    (x', z', u', r')."""
    c = converged[:, None]
    gemv = gemv_early_exit if gemv is None else gemv
    xk = gemv(P, r, x, converged) + torch.where(c, 0.0, q)
    # For frozen elements the GEMV returns x (without q); re-freeze exactly.
    x_new = torch.where(c, x, xk)
    xh = alpha * x_new + (1.0 - alpha) * z if alpha != 1.0 else x_new
    z_new = torch.where(c, z, torch.clamp(xh + u, lb, ub))
    u_new = torch.where(c, u, u + (xh - z_new))
    r_new = torch.where(c, r, -p + rho[..., None] * (z_new - u_new))
    return x_new, z_new, u_new, r_new
