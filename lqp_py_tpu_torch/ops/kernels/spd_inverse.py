"""Batched SPD inverse of 128x128 blocks: the leaf of the Schur recursion.

``sweep_spd_inverse`` launches the hand-written CUDA kernel
(``csrc/sweep_spd_inverse.cu``) for a CUDA tensor and runs the plain
PyTorch version, ``sweep_spd_inverse_ref``, for a CPU tensor.  Both
compute the symmetric SWEEP recurrence of the Pallas leaf
(lqp_py_tpu/ops/pallas/spd_inverse.py) in its textbook form: sweeping
pivot k of a symmetric A with d = A[k,k] maps

    A[k,k] -> -1/d,   A[i,k], A[k,j] -> A[i,k]/d, A[k,j]/d,
    A[i,j] -> A[i,j] - A[i,k] A[k,j] / d          (i, j != k),

and sweeping every pivot of an SPD matrix gives -A^-1, negated on the
way out.  The Pallas leaf's batch padding (a Mosaic compile-cache
workaround) is not needed: the kernel takes any B.
"""

from __future__ import annotations

import torch

LEAF = 128

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0


def sweep_spd_inverse_ref(H: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SWEEP inverse of a (B, m, m) stack of SPD matrices."""
    A = H.clone()
    for k in range(A.shape[-1]):
        row = A[:, k, :].clone()                 # pivot row == column
        dinv = 1.0 / row[:, k]
        v = row * dinv[:, None]
        A -= row[:, :, None] * v[:, None, :]
        A[:, k, :] = v
        A[:, :, k] = v
        A[:, k, k] = -dinv
    return -A


def sweep_spd_inverse(H: torch.Tensor) -> torch.Tensor:
    """H^-1 for a (B, 128, 128) stack of SPD matrices.

    A CPU tensor takes the plain version.  A CUDA tensor must be
    contiguous float32 of shape (B, 128, 128) and always goes to the
    kernel; anything else raises."""
    global LAUNCHES
    if H.device.type == "cpu":
        return sweep_spd_inverse_ref(H)
    if H.device.type != "cuda":
        raise ValueError(f"sweep_spd_inverse: unsupported device {H.device}")
    if (H.dtype != torch.float32 or H.ndim != 3
            or tuple(H.shape[1:]) != (LEAF, LEAF)):
        raise ValueError(
            f"sweep_spd_inverse kernel takes float32 (B, {LEAF}, {LEAF}), "
            f"got {H.dtype} {tuple(H.shape)}")
    if not H.is_contiguous():
        raise ValueError("sweep_spd_inverse kernel needs a contiguous input")
    from lqp_py_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    out = torch.empty_like(H)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = lib.sweep_spd_inverse_f32(H.data_ptr(), out.data_ptr(),
                                       H.shape[0], LEAF, stream)
    if rc != 0:
        raise RuntimeError(f"sweep_spd_inverse kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return out
