"""Batched SPD inverse of 128x128 blocks: the leaf of the Schur recursion.

``sweep_spd_inverse`` launches the hand-written CUDA kernel
(``csrc/sweep_spd_inverse.cu``) for a CUDA tensor and runs the plain
PyTorch version, ``sweep_spd_inverse_ref``, for a CPU tensor.  Both
compute the symmetric SWEEP recurrence of the Pallas leaf
(lqp_py_tpu/ops/pallas/spd_inverse.py): sweeping pivot k of a symmetric A
with d = A[k,k] maps

    A[k,k] -> -1/d,   A[i,k], A[k,j] -> A[i,k]/d, A[k,j]/d,
    A[i,j] -> A[i,j] - A[i,k] A[k,j] / d          (i, j != k),

and sweeping every pivot of an SPD matrix gives -A^-1, negated on the
way out.  The plain version takes one pivot per step in this textbook
form; the kernel takes pivots in pairs, one rank-2 update each, in the
Pallas leaf's ``u = row - e_k`` form (``csrc/sweep_tile.cuh``).  The
Pallas leaf's batch padding (a Mosaic compile-cache workaround) is not
needed: the kernel takes any B.
"""

from __future__ import annotations

import torch

from lqp_py_tpu_torch.ops.kernels import _build

LEAF = 128

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0


def sweep_spd_inverse_ref(H: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch SWEEP inverse of a (B, m, m) stack of SPD matrices,
    copied into ``out`` where one is given (which may be H)."""
    A = H.clone()
    for k in range(A.shape[-1]):
        row = A[:, k, :].clone()                 # pivot row == column
        dinv = 1.0 / row[:, k]
        v = row * dinv[:, None]
        A -= row[:, :, None] * v[:, None, :]
        A[:, k, :] = v
        A[:, :, k] = v
        A[:, k, k] = -dinv
    return -A if out is None else torch.neg(A, out=out)


def _check_view(name: str, X: torch.Tensor) -> None:
    if X.stride(2) != 1 or X.stride(1) < LEAF:
        raise ValueError(
            f"sweep_spd_inverse kernel: {name} needs rows of unit stride at "
            f"least {LEAF} apart, got strides {X.stride()}")


def sweep_spd_inverse(H: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """H^-1 for a (B, 128, 128) stack of SPD matrices, written into ``out``
    where one is given, else into a new contiguous stack; returns it.

    A CPU tensor takes the plain version.  A CUDA tensor must be float32 of
    shape (B, 128, 128) with unit column stride and a row stride of at
    least 128 (a diagonal-block view of a larger stack is read in place);
    ``out`` is such a view too, of H's shape, and may be H itself.  It
    always goes to the kernel, and anything else raises."""
    global LAUNCHES
    if H.device.type == "cpu":
        return sweep_spd_inverse_ref(H, out)
    if H.device.type != "cuda":
        raise ValueError(f"sweep_spd_inverse: unsupported device {H.device}")
    if (H.dtype != torch.float32 or H.ndim != 3
            or tuple(H.shape[1:]) != (LEAF, LEAF)):
        raise ValueError(
            f"sweep_spd_inverse kernel takes float32 (B, {LEAF}, {LEAF}), "
            f"got {H.dtype} {tuple(H.shape)}")
    _check_view("H", H)
    if out is None:
        out = torch.empty((H.shape[0], LEAF, LEAF), dtype=H.dtype,
                          device=H.device)
    elif (out.dtype != H.dtype or out.shape != H.shape
          or out.device != H.device):
        raise ValueError(
            f"sweep_spd_inverse: out must be {H.dtype} {tuple(H.shape)} on "
            f"{H.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    _check_view("out", out)
    dev = H.device.index
    args = (H.data_ptr(), H.stride(0), H.stride(1), out.data_ptr(),
            out.stride(0), out.stride(1), H.shape[0], LEAF,
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.load_library()               # loaded once, then cached
    if dev == torch.cuda.current_device():
        rc = lib.sweep_spd_inverse_f32(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.sweep_spd_inverse_f32(*args)
    if rc != 0:
        raise RuntimeError(f"sweep_spd_inverse kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return out
