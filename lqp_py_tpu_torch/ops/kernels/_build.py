"""Build the package's CUDA sources with nvcc and load them with ctypes.

``load_library()`` compiles every ``lqp_py_tpu_torch/csrc/*.cu`` (one nvcc
per source, all started together; ``*.cuh`` are headers they include)
and links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) under ``build/lqp_py_tpu_torch/`` at the repository root.
The file name carries a hash of the sources, headers and flags: an edited
source builds anew, an unchanged one is loaded as it is.  Nothing here runs at
import time, so machines without ``nvcc`` can import the package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lqp_py_tpu_torch"
#: Where the CUDA toolkit puts nvcc when it is not on PATH.
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and DEFAULT_NVCC.exists():
        path = str(DEFAULT_NVCC)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lqp_py_tpu_torch need the CUDA toolkit to build")
    return path


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*_sources(), *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblqp_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the first failure's output
    once every one of them has ended."""
    procs = []
    try:
        for cmd in cmds:
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        results = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, proc in procs]
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, log, rc in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a temporary directory and rename the library into place:
    # concurrent processes never load a half-written one.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc, srcs = _nvcc(), _sources()
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in zip(srcs, objs))
        lib = Path(tmp) / out.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        os.replace(lib, out)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    fn = lib.sweep_spd_inverse_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("sweep_spd_inverse_attributes",
                 "gemv_early_exit_attributes",
                 "block_spd_inverse_attributes"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
    fn = lib.gemv_early_exit_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.gemv_early_exit_rect_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mirror_block_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.block_spd_inverse_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def kernel_attributes(kernel: str) -> dict:
    """``{"regs": registers per thread, "local_bytes": local-memory bytes
    per thread}`` of the compiled ``kernel`` ("sweep_spd_inverse",
    "gemv_early_exit" or "block_spd_inverse"); local bytes other than 0 mean
    registers spilled."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = getattr(load_library(), f"{kernel}_attributes")(
        ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"{kernel}_attributes: CUDA error {rc}")
    return {"regs": regs.value, "local_bytes": local.value}
