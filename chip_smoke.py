"""Drive the PyTorch port's forward box-QP path once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit.  It builds the SWEEP-leaf kernel from ``lqp_py_tpu_torch/csrc``
into ``build/``, checks the kernel against its plain PyTorch version, and
serves the reference's Experiment-1 shape (B=128 box QPs of n=1000, float32,
eps_abs = eps_rel = 1e-5): three direct requests, one of them checked
against a float64 solve, then a prepared problem answering four requests
with a drifting cost vector and warm starts.  Every phase raises on
failure.  The line before the last lists each kernel with its launches on
the serving path, its error against the plain version and both times; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA it exits
non-zero before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N, B, TOL = 1000, 128, 1e-5
LEAF = 128


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _event_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "check needs an NVIDIA GPU")
    from lqp_py_tpu_torch import (BoxQPConfig, prepare_box_qp, solve_box_qp,
                                  solve_box_qp_prepared)
    from lqp_py_tpu_torch.ops import linalg as lin
    from lqp_py_tpu_torch.ops.kernels import _build
    from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
    from lqp_py_tpu_torch.ops.precision import highest_matmul_precision
    from lqp_py_tpu_torch.utils.generators import create_qp_data

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")

    # 2. Build.
    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 2 build: {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. Kernel vs plain at the shape the recursion gives the leaf.
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((B, 2 * LEAF, LEAF), generator=g, device=dev)
    with highest_matmul_precision():
        H = (a.mT @ a) / (2 * LEAF) + torch.eye(LEAF, device=dev)
    Hk = sk.sweep_spd_inverse(H)
    Hr = sk.sweep_spd_inverse_ref(H)
    torch.cuda.synchronize()
    H64 = H.double()
    inv64 = torch.linalg.inv(H64)
    eye64 = torch.eye(LEAF, dtype=torch.float64, device=dev)
    max_abs = (Hk - Hr).abs().max().item()
    rel = max_abs / Hr.abs().max().item()
    res_k = (H64 @ Hk.double() - eye64).abs().max().item()
    res_r = (H64 @ Hr.double() - eye64).abs().max().item()
    err_k = (Hk.double() - inv64).abs().max().item()
    err_r = (Hr.double() - inv64).abs().max().item()
    _check(rel <= 1e-4, f"kernel vs plain relative difference {rel:.3e}")
    _check(res_k <= 1e-4 and res_r <= 1e-4,
           f"leaf residuals kernel {res_k:.3e}, plain {res_r:.3e}")
    # Turns: plain, kernel, kernel, plain (after one warm-up each).
    sk.sweep_spd_inverse(H), sk.sweep_spd_inverse_ref(H)
    t_p1 = _event_ms(lambda: sk.sweep_spd_inverse_ref(H), 5)
    t_k1 = _event_ms(lambda: sk.sweep_spd_inverse(H), 20)
    t_k2 = _event_ms(lambda: sk.sweep_spd_inverse(H), 20)
    t_p2 = _event_ms(lambda: sk.sweep_spd_inverse_ref(H), 5)
    kernel_ms, plain_ms = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
    print(f"phase 3 leaf ({B},{LEAF},{LEAF}) f32: max|kernel-plain| "
          f"{max_abs:.3e} (rel {rel:.3e} <= 1e-4); |H Hinv - I|max kernel "
          f"{res_k:.3e}, plain {res_r:.3e} (<= 1e-4); |Hinv - inv_f64|max "
          f"kernel {err_k:.3e}, plain {err_r:.3e}; kernel {kernel_ms:.4f} ms "
          f"({t_k1:.4f}, {t_k2:.4f}), plain {plain_ms:.4f} ms "
          f"({t_p1:.4f}, {t_p2:.4f})")

    # 4. One factorization at the serving shape (bench.py's probe).
    data0 = create_qp_data(N, B, seed=0, dtype=torch.float32, device=dev)
    eyeN = torch.eye(N, device=dev)
    Hq = data0.Q + eyeN
    with highest_matmul_precision():
        before = sk.LAUNCHES
        Hi = lin.spd_inverse_fast(Hq)
        leaf_calls = sk.LAUNCHES - before
        res = (Hq @ Hi - eyeN).abs().max().item()
        fact_ms = _event_ms(lambda: lin.spd_inverse_fast(Hq), 3)
    del Hi
    _check(res < 1e-4, f"factorization residual {res:.3e}")
    _check(leaf_calls == 8, f"{leaf_calls} leaf launches, expected 8")
    print(f"phase 4 spd_inverse_fast(Q + I) B={B} n={N} f32: |H Hinv - I|max "
          f"{res:.3e} (< 1e-4), {leaf_calls} leaf launches, "
          f"{fact_ms:.3f} ms")

    # 5-6: the serving path; only its kernel launches are counted.
    cfg = BoxQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False)
    sk.LAUNCHES = 0

    # 5. Direct requests.
    direct0 = None
    for seed in range(3):
        data = data0 if seed == 0 else create_qp_data(
            N, B, seed=seed, dtype=torch.float32, device=dev)
        sol, ms = _wall_ms(lambda: solve_box_qp(*data, config=cfg))
        _check(tuple(sol.x.shape) == (B, N)
               and bool(torch.isfinite(sol.x).all()),
               f"seed {seed}: x not finite of shape ({B}, {N})")
        _check(bool(sol.converged.all()),
               f"seed {seed}: {int(sol.converged.sum())}/{B} converged")
        _check(not bool(sol.primal_infeasible.any()),
               f"seed {seed}: flagged infeasible")
        print(f"phase 5 direct request seed={seed}: {sol.iterations} "
              f"iterations, {B}/{B} converged, rho "
              f"[{sol.rho.min().item():.4g}, {sol.rho.max().item():.4g}], "
              f"{ms:.2f} ms")
        if seed == 0:
            direct0 = sol
    d64 = [t.double() for t in data0]
    cfg64 = BoxQPConfig(eps_abs=1e-9, eps_rel=1e-9, symmetrize=False)
    sol64, ms64 = _wall_ms(lambda: solve_box_qp(*d64, config=cfg64))
    _check(bool(sol64.converged.all()), "float64 reference did not converge")
    dx64 = (direct0.x.double() - sol64.x).abs().max().item()
    _check(dx64 <= 1e-3, f"max|x_f32 - x_f64| = {dx64:.3e}")
    print(f"phase 5 float64 reference (Cholesky, tol 1e-9): "
          f"{sol64.iterations} iterations, {ms64:.2f} ms; "
          f"max|x_f32 - x_f64| {dx64:.3e} (<= 1e-3)")
    del sol64, d64

    # 6. Serving: one preparation, four requests with p drifting by 1% per
    # request, each warm-started from the previous answer.
    prep, prep_ms = _wall_ms(lambda: prepare_box_qp(
        data0.Q, data0.A, data0.b, data0.lb, data0.ub, config=cfg))
    gp = np.random.default_rng(1)
    p = data0.p
    prev = None
    lines = []
    for k in range(4):
        if k:
            noise = torch.as_tensor(gp.standard_normal(p.shape),
                                    dtype=p.dtype, device=dev)
            p = p + 0.01 * p.abs().mean() * noise
        sol, ms = _wall_ms(lambda: solve_box_qp_prepared(
            prep, p, config=cfg, warm_start=prev))
        _check(bool(sol.converged.all()) and bool(torch.isfinite(sol.x).all()),
               f"prepared request {k}: {int(sol.converged.sum())}/{B} "
               f"converged")
        if k == 0:
            dprep = (sol.x - direct0.x).abs().max().item()
            _check(dprep <= 1e-6,
                   f"prepared vs direct solve differ by {dprep:.3e}")
        lines.append(f"{sol.iterations} it {ms:.2f} ms")
        prev = sol
    launches = sk.LAUNCHES
    print(f"phase 6 serving: prepare {prep_ms:.2f} ms; requests "
          f"[{'; '.join(lines)}]; first request vs direct solve "
          f"{dprep:.3e} (<= 1e-6)")
    _check(launches > 0, "the serving path launched no sweep kernel")

    print(json.dumps({"kernels": [{
        "name": "sweep_spd_inverse", "route": "cuda",
        "source": "lqp_py_tpu_torch/csrc/sweep_spd_inverse.cu",
        "replaces": "lqp_py_tpu/ops/pallas/spd_inverse.py:53",
        "launches": launches, "max_abs_err": max_abs,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
