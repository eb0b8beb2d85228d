"""Drive the PyTorch port's forward box-QP path once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit.  It builds both kernels (the SWEEP leaf and the early-exit GEMV)
from ``lqp_py_tpu_torch/csrc`` into ``build/`` and checks each against its
plain PyTorch version.  Then it serves the reference's Experiment-1 shape
(B=128 box QPs of n=1000, float32, eps_abs = eps_rel = 1e-5): three direct
requests, one of them checked against a float64 solve, then a prepared
problem answering four requests with a drifting cost vector and warm
starts (phases 1-6).  Phase 7 times the early-exit GEMV against its plain
version at 0/50/90% of the batch converged, on the device alone and at the
host's pace; phase 8 solves the straggler serving batch of
experiments/experiment_straggler.py (8 hard problems among 120 ridged easy
ones, B=128, n=1000) lock-step and with the early-exit step, serves it
prepared, and reports the share of the batch the early-exit GEMV found
frozen.  Every phase raises on failure.
The line before the last lists each kernel with its launches on the
serving paths, its error against the plain version and both times; the
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
N_HARD = 8          # stragglers in the phase-8 batch
N_PAD = 1024        # n=1000 padded to the 128 and to the 256 alignment


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _event_ms(fn, reps, queued=False):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls.

    With ``queued`` the stream is first held by a spin kernel long enough
    for the host to enqueue every call, so the time is the device's alone;
    without it a call whose host side outlasts its kernel is timed at the
    host's pace, as the solver loop sees it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(reps * 2e5))      # ~0.1 ms per call at ~2 GHz
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
    from lqp_py_tpu_torch.ops.kernels import admm_step as gk
    from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
    from lqp_py_tpu_torch.ops.precision import highest_matmul_precision
    from lqp_py_tpu_torch.utils.generators import (create_qp_data,
                                                   generate_hard_qp)

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
    _check(gk.LAUNCHES == 0, "the lock-step path launched the early-exit "
           "GEMV")
    del data, data0, direct0, prep, prev, sol

    # 7. Early-exit GEMV vs plain at the shape the solver gives it, with a
    # fixed share of the batch converged.  Turns: plain, kernel, kernel,
    # plain (after one warm-up each).
    g7 = torch.Generator(device=dev).manual_seed(7)
    P7 = torch.randn((B, N_PAD, N_PAD), generator=g7, device=dev)
    r7 = torch.randn((B, N_PAD), generator=g7, device=dev)
    x7 = torch.randn((B, N_PAD), generator=g7, device=dev)
    order = torch.randperm(B, generator=g7, device=dev)
    gemv = {}
    with highest_matmul_precision():
        for frac in (0.0, 0.5, 0.9):
            conv = torch.zeros(B, dtype=torch.bool, device=dev)
            conv[order[:round(frac * B)]] = True
            out = gk.gemv_early_exit(P7, r7, x7, conv)
            ref = gk.gemv_early_exit_ref(P7, r7, x7, conv)
            torch.cuda.synchronize()
            _check(torch.equal(out[conv], x7[conv]),
                   f"{frac:.0%} converged: frozen rows are not x_prev")
            act = ~conv
            err = (out[act] - ref[act]).abs().max().item()
            rel = err / ref[act].abs().max().item()
            _check(rel <= 1e-5, f"{frac:.0%} converged: kernel vs plain "
                   f"relative difference {rel:.3e}")

            def kern():
                gk.gemv_early_exit(P7, r7, x7, conv)

            def plain():
                gk.gemv_early_exit_ref(P7, r7, x7, conv)

            times = {}
            for queued in (True, False):
                t_p1 = _event_ms(plain, 20, queued)
                t_k1 = _event_ms(kern, 20, queued)
                t_k2 = _event_ms(kern, 20, queued)
                t_p2 = _event_ms(plain, 20, queued)
                times[queued] = (t_k1, t_k2, t_p1, t_p2)
            t_k1, t_k2, t_p1, t_p2 = times[True]
            h_k1, h_k2, h_p1, h_p2 = times[False]
            gemv[frac] = dict(ms=(t_k1 + t_k2) / 2, plain_ms=(t_p1 + t_p2) / 2,
                              paced_ms=(h_k1 + h_k2) / 2,
                              paced_plain_ms=(h_p1 + h_p2) / 2, err=err)
            print(f"phase 7 early-exit GEMV ({B},{N_PAD},{N_PAD}) f32, "
                  f"{int(conv.sum())}/{B} converged: max|kernel-plain| "
                  f"{err:.3e} (rel {rel:.3e} <= 1e-5), frozen rows bitwise; "
                  f"device time kernel {gemv[frac]['ms']:.4f} ms "
                  f"({t_k1:.4f}, {t_k2:.4f}), plain "
                  f"{gemv[frac]['plain_ms']:.4f} ms ({t_p1:.4f}, "
                  f"{t_p2:.4f}); host-paced kernel "
                  f"{gemv[frac]['paced_ms']:.4f} ms ({h_k1:.4f}, {h_k2:.4f}), "
                  f"plain {gemv[frac]['paced_plain_ms']:.4f} ms ({h_p1:.4f}, "
                  f"{h_p2:.4f})")
    del P7
    # Bytes the kernel must move with none converged: all of P, r, x_prev
    # (unread then, but counted as the plain version reads it) and out.
    bytes0 = 4 * B * N_PAD * (N_PAD + 3)
    gbps0 = bytes0 / (gemv[0.0]["ms"] * 1e-3) / 1e9
    ratio90 = gemv[0.9]["ms"] / gemv[0.0]["ms"]
    print(f"phase 7 kernel at 0% converged: {gbps0:.1f} GB/s "
          f"({bytes0 / 1e6:.1f} MB); 90%/0% device time ratio {ratio90:.3f} "
          f"(< 0.5), host-paced "
          f"{gemv[0.9]['paced_ms'] / gemv[0.0]['paced_ms']:.3f}")
    _check(ratio90 < 0.5, f"90%-converged GEMV takes {ratio90:.3f} of the "
           f"0% time: frozen panels are read")

    # 8. Straggler serving batch (experiments/experiment_straggler.py):
    # hard problems, all but N_HARD ridged with mean(diag Q) * I.
    hard = generate_hard_qp(N, B, seed=0, dtype=torch.float32, device=dev)
    ridge = hard.Q.diagonal(dim1=-2, dim2=-1).mean(dim=-1)
    is_easy = torch.arange(B, device=dev) < B - N_HARD
    Q8 = hard.Q + torch.where(is_easy, ridge, 0.0)[:, None, None] * torch.eye(
        N, device=dev)
    data8 = (Q8, *hard[1:])
    del hard
    base = dict(eps_abs=TOL, eps_rel=TOL, symmetrize=False, max_iters=4000)
    cfg_lock = BoxQPConfig(**base)
    cfg_early = BoxQPConfig(use_pallas_step=True, **base)
    leaves_per_fact = N_PAD // LEAF
    sk.LAUNCHES = gk.LAUNCHES = 0

    def serve8(name, fn, gemv_expected):
        s0, g0 = sk.LAUNCHES, gk.LAUNCHES
        sol, ms = _wall_ms(fn)
        leaves, gemvs = sk.LAUNCHES - s0, gk.LAUNCHES - g0
        n_conv = int(sol.converged.sum())
        _check(n_conv == B and bool(torch.isfinite(sol.x).all()),
               f"{name}: {n_conv}/{B} converged")
        _check(not bool(sol.primal_infeasible.any()),
               f"{name}: flagged infeasible")
        want = sol.iterations if gemv_expected else 0
        _check(gemvs == want, f"{name}: {gemvs} early-exit GEMV launches "
               f"for {sol.iterations} iterations (want {want})")
        _check(leaves % leaves_per_fact == 0,
               f"{name}: {leaves} leaf launches")
        return sol, ms, dict(it=sol.iterations, conv=n_conv, gemv=gemvs,
                             refact=leaves // leaves_per_fact)

    # One warm-up each, then 3 timed rounds in turns (lock-step,
    # early-exit): the host clock drifts over a call.
    paths8 = (("lock-step", cfg_lock), ("early-exit", cfg_early))
    runs8 = {name: [] for name, _ in paths8}
    sols8 = {}
    for _ in range(4):
        for name, cfg8 in paths8:
            sol, ms, st = serve8(name, lambda: solve_box_qp(
                *data8, config=cfg8), cfg8.use_pallas_step)
            st["refact"] -= 1           # the initial factorization
            runs8[name].append((ms, st))
            sols8[name] = sol
    for name, runs in runs8.items():
        its = {st["it"] for _, st in runs}
        _check(len(its) == 1, f"{name}: iterations vary over repeats {its}")
        st = runs[-1][1]
        print(f"phase 8 straggler {name} (B={B}, n={N}, {N_HARD} hard, f32, "
              f"tol {TOL:g}): {st['it']} iterations, {st['conv']}/{B} "
              f"converged, {st['refact']} refactorizations, {st['gemv']} "
              f"early-exit GEMV launches; wall ms warm-up "
              f"{runs[0][0]:.2f}, timed "
              f"[{', '.join(f'{ms:.2f}' for ms, _ in runs[1:])}]")
    dx8 = (sols8["early-exit"].x - sols8["lock-step"].x).abs().max().item()
    _check(dx8 <= 1e-2, f"max|x_early - x_lockstep| = {dx8:.3e}")
    print(f"phase 8 max|x_early - x_lockstep| {dx8:.3e} (<= 1e-2)")

    # Served prepared: one preparation for the early-exit step, a request
    # at p (checked against the direct solve) and one at p drifted by 1%,
    # warm-started.
    Q8, p8, A8, b8, lb8, ub8 = data8
    prep8, prep8_ms = _wall_ms(lambda: prepare_box_qp(
        Q8, A8, b8, lb8, ub8, config=cfg_early))
    sol_a, ms_a, st_a = serve8("prepared request 1", lambda:
                               solve_box_qp_prepared(prep8, p8,
                                                     config=cfg_early), True)
    dprep8 = (sol_a.x - sols8["early-exit"].x).abs().max().item()
    _check(dprep8 <= 1e-6, f"prepared vs direct early-exit solve differ by "
           f"{dprep8:.3e}")
    noise = torch.as_tensor(np.random.default_rng(8).standard_normal(
        tuple(p8.shape)), dtype=p8.dtype, device=dev)
    p8b = p8 + 0.01 * p8.abs().mean() * noise
    _sol_b, ms_b, st_b = serve8("prepared request 2", lambda:
                                solve_box_qp_prepared(prep8, p8b,
                                                      config=cfg_early,
                                                      warm_start=sol_a), True)
    print(f"phase 8 served prepared (early-exit): prepare {prep8_ms:.2f} ms; "
          f"request 1 {st_a['it']} it {ms_a:.2f} ms, {st_a['refact']} "
          f"refactorizations; request 2 (p drifted 1%, warm) {st_b['it']} it "
          f"{ms_b:.2f} ms, {st_b['refact']} refactorizations; request 1 vs "
          f"direct solve {dprep8:.3e} (<= 1e-6)")
    launches8_sweep, launches8_gemv = sk.LAUNCHES, gk.LAUNCHES
    _check(launches8_sweep > 0 and launches8_gemv > 0,
           f"the straggler path launched {launches8_sweep} sweep and "
           f"{launches8_gemv} early-exit GEMV kernels")

    # What the early-exit GEMV could skip: the converged count it was given
    # at each iteration of one more direct solve (after the counts above
    # were read).
    frozen = []
    kernel_fn = gk.gemv_early_exit

    def spy(P, r, x_prev, converged):
        frozen.append(converged.sum())
        return kernel_fn(P, r, x_prev, converged)

    gk.gemv_early_exit = spy
    try:
        solve_box_qp(*data8, config=cfg_early)
    finally:
        gk.gemv_early_exit = kernel_fn
    frozen = torch.stack(frozen).tolist()
    steps = [f"{c}@{i + 1}" for i, c in enumerate(frozen)
             if i == 0 or c != frozen[i - 1]]
    easy_at = next((i + 1 for i, c in enumerate(frozen)
                    if c >= B - N_HARD), None)
    share8 = sum(frozen) / (B * len(frozen))
    print(f"phase 8 frozen share over the early-exit solve's {len(frozen)} "
          f"iterations: mean {share8:.4f}; {B - N_HARD}+ frozen from "
          f"iteration {easy_at}; frozen count@iteration "
          f"[{', '.join(steps)}]")

    print(json.dumps({"kernels": [{
        "name": "sweep_spd_inverse", "route": "cuda",
        "source": "lqp_py_tpu_torch/csrc/sweep_spd_inverse.cu",
        "replaces": "lqp_py_tpu/ops/pallas/spd_inverse.py:53",
        "launches": launches, "launches_straggler": launches8_sweep,
        "max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms}, {
        "name": "gemv_early_exit", "route": "cuda",
        "source": "lqp_py_tpu_torch/csrc/gemv_early_exit.cu",
        "replaces": "lqp_py_tpu/ops/pallas/admm_step.py:52",
        "launches": launches8_gemv,
        "max_abs_err": max(v["err"] for v in gemv.values()),
        "ms": gemv[0.0]["ms"], "plain_ms": gemv[0.0]["plain_ms"],
        "ms_50": gemv[0.5]["ms"], "plain_ms_50": gemv[0.5]["plain_ms"],
        "ms_90": gemv[0.9]["ms"], "plain_ms_90": gemv[0.9]["plain_ms"],
        "paced_ms": {f"{f:.0%}": gemv[f]["paced_ms"] for f in gemv},
        "paced_plain_ms": {f"{f:.0%}": gemv[f]["paced_plain_ms"]
                           for f in gemv},
        "gb_per_s_0": gbps0, "frozen_share_straggler": share8}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
