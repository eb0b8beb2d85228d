"""Batched transposed copy of a block: the mirror step of the Schur
recursion (``ops/linalg.py`` ``_invert_into``), which writes ``(-U)^T``
below the diagonal once ``-U`` is above it.

``mirror_block`` launches the hand-written CUDA kernel
(``csrc/mirror_block.cu``) for a CUDA tensor and runs the plain version,
``mirror_block_ref``, for a CPU tensor.  No TPU kernel corresponds: the JAX
package joins the blocks with ``jnp.concatenate``.
"""

from __future__ import annotations

import torch

from lqp_py_tpu_torch.ops.kernels import _build

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0


def mirror_block_ref(src: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``out <- src^T``, batched."""
    return out.copy_(src.mT)


def mirror_block(src: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[b] = src[b]^T`` for (B, r, c) ``src`` and (B, c, r) ``out``;
    returns ``out``.

    A CPU tensor takes the plain version.  A CUDA pair must be float32 on
    one device, each with unit column stride (the recursion's block views
    of one buffer, read and written through their row strides), and must
    not overlap; it always goes to the kernel, and anything else raises."""
    global LAUNCHES
    if src.device.type == "cpu":
        return mirror_block_ref(src, out)
    if src.device.type != "cuda":
        raise ValueError(f"mirror_block: unsupported device {src.device}")
    if (src.dtype != torch.float32 or out.dtype != torch.float32
            or src.ndim != 3 or out.shape != src.mT.shape
            or out.device != src.device):
        raise ValueError(
            f"mirror_block kernel takes float32 (B, r, c) and (B, c, r) on "
            f"one device, got {src.dtype} {tuple(src.shape)} on {src.device}"
            f" and {out.dtype} {tuple(out.shape)} on {out.device}")
    B, rows, cols = src.shape
    if (src.stride(2) != 1 or out.stride(2) != 1 or src.stride(1) < cols
            or out.stride(1) < rows):
        raise ValueError(
            f"mirror_block kernel reads and writes rows of unit stride, got "
            f"strides {src.stride()} and {out.stride()}")
    dev = src.device.index
    args = (src.data_ptr(), src.stride(0), src.stride(1), out.data_ptr(),
            out.stride(0), out.stride(1), B, rows, cols,
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.load_library()               # loaded once, then cached
    if dev == torch.cuda.current_device():
        rc = lib.mirror_block_f32(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.mirror_block_f32(*args)
    if rc != 0:
        raise RuntimeError(f"mirror_block kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return out
