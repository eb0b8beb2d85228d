"""Whole-matrix batched SPD inverse by the block sweep (counterpart of
``lqp_py_tpu.ops.pallas.block_inverse``).

For each 128-wide diagonal block K of a symmetric M (initially H):

    D       = M[K, K]                 (SPD Schur complement)
    V       = M[:, K] D^-1            (n x 128 panel)
    M       = M - V M[:, K]^T         (rank-128 update)
    M[:, K] = V,  M[K, :] = V^T,  M[K, K] = -D^-1

and after every block ``M == -H^-1``.  ``block_spd_inverse`` launches the
hand-written CUDA kernel (``csrc/block_spd_inverse.cu``) for a CUDA tensor
and runs the plain PyTorch version, ``block_spd_inverse_ref``, for a CPU
tensor.  As in the JAX package, no solver calls it: the recursion of
``ops/linalg.py`` (``spd_inverse_fast``) inverts the factorization
operand.  Input contract: (approximately) Jacobi-equilibrated, like the
recursion's.
"""

from __future__ import annotations

import torch

from lqp_py_tpu_torch.ops.kernels.spd_inverse import sweep_spd_inverse_ref

BLK = 128

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0


def _check_shape(H):
    if H.ndim != 3 or H.shape[1] != H.shape[2] or H.shape[-1] % BLK:
        raise ValueError(
            f"block_spd_inverse takes (B, n, n) with n a multiple of {BLK}, "
            f"got {tuple(H.shape)}")


def block_spd_inverse_ref(H: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch block sweep of a (B, n, n) SPD stack, n % 128 == 0."""
    _check_shape(H)
    M = H.clone()
    for off in range(0, H.shape[-1], BLK):
        K = slice(off, off + BLK)
        Dinv = sweep_spd_inverse_ref(M[:, K, K])
        C = M[:, :, K].clone()
        V = C @ Dinv
        M -= V @ C.mT
        M[:, :, K] = V
        M[:, K, :] = V.mT
        M[:, K, K] = -Dinv
    return -M


def block_spd_inverse(H: torch.Tensor) -> torch.Tensor:
    """H^-1 for a (B, n, n) stack of SPD matrices with n % 128 == 0.

    A CPU tensor takes the plain version.  A CUDA tensor must be
    contiguous float32 and always goes to the kernel; anything else
    raises."""
    global LAUNCHES
    _check_shape(H)
    if H.device.type == "cpu":
        return block_spd_inverse_ref(H)
    if H.device.type != "cuda":
        raise ValueError(f"block_spd_inverse: unsupported device {H.device}")
    if H.dtype != torch.float32:
        raise ValueError(f"block_spd_inverse kernel takes float32, got "
                         f"{H.dtype}")
    if not H.is_contiguous():
        raise ValueError("block_spd_inverse kernel needs a contiguous input")
    from lqp_py_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    B, n, _ = H.shape
    out = torch.empty_like(H)
    # Per-matrix scratch, (n, 128) rows with the pivot index contiguous
    # (the K-major layout the tensor-core products read): the column
    # panel's rows below the pivot block, and W = -V.
    ct = torch.empty((B, n, BLK), dtype=H.dtype, device=H.device)
    w = torch.empty_like(ct)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = lib.block_spd_inverse_f32(H.data_ptr(), out.data_ptr(),
                                       ct.data_ptr(), w.data_ptr(), B, n,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"block_spd_inverse kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return out
