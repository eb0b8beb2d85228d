"""ctypes binding to the native C++ CPU box-QP solver
(``native/lqp_native.cpp``), the port's own.

The first call compiles the source with ``g++`` into
``build/lqp_py_tpu_torch/native/`` at the repository root, under a name
carrying a hash of the source and the flags (as ``ops/kernels/_build.py``
names the CUDA library): an edited source builds anew, an unchanged one is
loaded as it is.  The source is only read; nothing is written under
``native/``, and the flags name no host-specific instruction set, so the
library runs on whatever machine built it.  Without a compiler or a source
``available()`` is False, and callers skip the native column.  The solver is
an independent correctness oracle and the sequential CPU baseline of
Experiment 1 (the role SCS plays for the reference, scs_qp.py:97-108).
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
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "lqp_native.cpp"
BUILD_DIR = _REPO / "build" / "lqp_py_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-fopenmp", "-shared")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblqp_native_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename into place: concurrent processes
    # never load a half-written library.
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(lib, out)


@functools.cache
def load_library() -> Optional[ctypes.CDLL]:
    """The built library (building it if the source changed), or None when
    there is no source or it cannot be compiled."""
    if not SOURCE.exists():
        return None
    path = library_path()
    if not path.exists():
        try:
            _compile(path)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
    lib = ctypes.CDLL(str(path))
    d = ctypes.POINTER(ctypes.c_double)
    i = ctypes.POINTER(ctypes.c_int)
    lib.lqp_solve_box_qp_batch.restype = ctypes.c_int
    lib.lqp_solve_box_qp_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        d, d, d, d, d, d,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
        d, d, d, d, i, d, d,
    ]
    lib.lqp_solve_box_qp_batch_mt.restype = ctypes.c_int
    lib.lqp_solve_box_qp_batch_mt.argtypes = (
        [ctypes.c_int] + list(lib.lqp_solve_box_qp_batch.argtypes))
    return lib


def available() -> bool:
    return load_library() is not None


def solve_box_qp_native(Q, p, A=None, b=None, lb=None, ub=None,
                        rho: float = -1.0, eps_abs: float = 1e-6,
                        eps_rel: float = 1e-6, max_iters: int = 100000,
                        check_every: int = 0, n_threads: int = 1):
    """Batched solve through the C++ core, on numpy arrays (float64; (B, n)
    vectors).  Returns a dict with x, z, nus, lams (signed), iters,
    primal/dual residuals and status.

    ``n_threads``: 1 -> sequential batch loop (the reference's SCS-wrapper
    pattern, scs_qp.py:97-108); 0 -> all cores via OpenMP; k > 1 -> k
    OpenMP threads."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native solver unavailable (no source or no "
                           "compiler)")

    Q = np.ascontiguousarray(np.asarray(Q, np.float64))
    p = np.ascontiguousarray(np.asarray(p, np.float64))
    B, n = p.shape[0], p.shape[1]
    if A is not None:
        A = np.ascontiguousarray(np.asarray(A, np.float64))
        b = np.ascontiguousarray(np.asarray(b, np.float64)).reshape(B, -1)
        m = A.shape[1]
    else:
        m = 0
    if lb is None:
        lb = np.full((B, n), -np.inf)
    if ub is None:
        ub = np.full((B, n), np.inf)
    lb = np.ascontiguousarray(np.asarray(lb, np.float64)).reshape(B, n)
    ub = np.ascontiguousarray(np.asarray(ub, np.float64)).reshape(B, n)
    p = p.reshape(B, n)

    x = np.zeros((B, n))
    z = np.zeros((B, n))
    nus = np.zeros((B, m)) if m > 0 else np.zeros((B, 0))
    lams = np.zeros((B, n))
    iters = np.zeros((B,), np.int32)
    primal = np.zeros((B,))
    dual = np.zeros((B,))

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    common = (
        B, n, m,
        ptr(Q), ptr(p),
        ptr(A) if m > 0 else None, ptr(b) if m > 0 else None,
        ptr(lb), ptr(ub),
        ctypes.c_double(rho), ctypes.c_double(eps_abs),
        ctypes.c_double(eps_rel), int(max_iters), int(check_every),
        ptr(x), ptr(z), ptr(nus) if m > 0 else None, ptr(lams),
        iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ptr(primal), ptr(dual))
    if n_threads != 1:
        status = lib.lqp_solve_box_qp_batch_mt(int(n_threads), *common)
    else:
        status = lib.lqp_solve_box_qp_batch(*common)

    return {
        "x": x, "z": z, "nus": nus if m > 0 else None, "lams": lams,
        "iters": iters, "primal": primal, "dual": dual, "status": status,
    }
