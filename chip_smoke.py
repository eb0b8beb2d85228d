"""Drive the PyTorch port's QP solver paths once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit.  It builds the four kernels (the SWEEP leaf, the recursion's
mirror, the early-exit GEMV and the block-sweep inverse) from
``lqp_py_tpu_torch/csrc`` into ``build/`` and checks each against its plain
PyTorch version.  Then it serves the reference's Experiment-1 shape
(B=128 box QPs of n=1000, float32, eps_abs = eps_rel = 1e-5): three direct
requests, one of them checked against a float64 solve, then a prepared
problem answering four requests with a drifting cost vector and warm
starts (phases 1-6).  Phase 3 also holds the leaf on a leading-block view
(read in place) bitwise to the leaf on its copy, and the leaf writing in
place over a diagonal block of a (B, 1024, 1024) stack bitwise to its new
output and near the plain leaf in place; fails if the leaf spills
registers, and times it on the device alone and at the host's pace.  It
then holds the mirror kernel bitwise to its plain version on the blocks an
n=1024 inverse mirrors, at the benchmark's batch of 512, and times the
seven mirrors of one inverse; phases 4-6 and 10 count its launches.
Phase 7 times the early-exit GEMV against its plain version at 0/50/90% of
the batch converged, on the device alone and at the host's pace, and in
turns with ``P @ r``, and sets the 90%/0% time ratio beside the active
share; phase 8 solves the straggler serving batch of
experiments/experiment_straggler.py (8 hard problems among 120 ridged easy
ones, B=128, n=1000) lock-step and with the early-exit step, serves it
prepared, and reports the share of the batch the early-exit GEMV found
frozen.  Phase 9 checks the whole-matrix block-sweep inverse at
(128, 1024, 1024) against its plain version and a float64 inverse, and
times it beside the solver's recursion (also in turns) and a Cholesky
inverse, with the bytes its design moves per call; phase 10 runs bench.py's
forward+backward (the differentiable layer, gradients with respect to Q
and p of ``sum(w * x)``) at B=128, n=1000 and holds the float32 backward
against a float64 one; phase 11 takes ten steps of the Experiment-2
trainer (n_x=500, minibatch 32 of 128, SGD).  Phase 7 also runs the GEMV
on a batch of 65536 (above the grid's y limit, launched in chunks).
Phases 12-15 drive the rest of the box-QP solver at B=128, n=1000: phase
12 Experiment 1's unrolled forward+backward (60 iterations, adaptive rho
off) against phase 10's fixed-point answer, with its peak memory; phase 13
the polish and the Cholesky KKT mode on phase 5's requests against the
float64 reference (the Cholesky mode launches no leaf); phase 14 Anderson
acceleration (window 10) on the straggler batch against its plain solve,
with the time of the m x m Gram inverse; phase 15 the equality-constrained
and unconstrained solvers' forward+backward against float64 runs.  Phases
16-18 drive Experiment 1's interior-point columns (OptNetConfig(tol 1e-5,
max_iters=30, symmetrize=False), polish on): phase 16 the box IP on phase
5's requests against the float64 answer, its forward+backward against a
float64 backward, and the leaf on the last iteration's IP operator (a
diagonal spanning ~1e8) against a float64 inverse beside the plain leaf;
phase 17 OptNet with the box as G = [-I; I] (condensed factorization) the
same way; phase 18 OptNet on general inequalities (ni=500 < n: Schur
factorization) gated on relative KKT residuals and against the condensed
factorization in float64.  Phase 19 drives Experiment 1's GenQP column, the
splitting solver on phase 5's requests with the box as G = [-I; I]
(GenQPConfig(tol, symmetrize=False)): a direct request against the float64
answer, the prepared serving rollout with warm starts
(experiments/experiment_serving.py:113-143), the layer's 'kkt'
forward+backward against a float64 backward (dG not built), a polished and
an Anderson solve, with every factorization's leaves counted; phase 20 the
conic backward at n=300 (its dense self-dual system under the 1 GiB
budget, warnings as errors) against float64 and against 'kkt'; phase 21
phase 11's trainer checkpointed after five steps, restored into a fresh
state and resumed, bitwise the uninterrupted run.  Phases 22-23 drive the
distribution layer (``lqp_py_tpu_torch.parallel``) on phase 5's requests,
in worker processes this script starts with ``--worker`` through
``parallel/launch.py``: phase 22 the batch-sharded (dp) solve in lock step
on two ranks of one card under gloo (chosen explicitly: NCCL refuses two
ranks on one device), its shard_map variant and ``boxqp_sharded``'s d/dp,
and the same dp solve in a one-rank world on the card's default backend
(NCCL); phase 23 the column-sharded (tp=2) box solve, with each rank's
leaf launches per factorization, the solve on the rank's own blocks with
the whole problem kept on the host, and the card memory each rank holds
(its blocks, the solve's temporaries, its peak over all it holds) against
a tp=1 solve.  Phases 24-26 run the column-sharded (tp=2) solves of the
other solver families in the same two-rank world: phase 24 GenQP on phase
19's requests (the Gram exchange and one factorization timed, the per-rank
memory against a tp=1 GenQP in the one-rank world), phase 25 the box IP on
phase 16's requests, OptNet Schur on phase 18's data and OptNet condensed
at n=256, phase 26 the box ADMM with polish (phase 13's requests), with
Anderson and with the early-exit step (phase 8's straggler batch; the
rectangular GEMV on the rank's block of P, counted per rank); phase 27, in
the same world, the box ADMM tp=2 in Cholesky mode on phase 13's requests
(no leaf; the distributed blocked Cholesky and one iteration's two
triangular sweeps timed; per-rank memory against a tp=1 Cholesky solve in
the one-rank world) and OptNet tp=2 without G on phase 15's requests
against its ``qp_eqcon``.  Phase 28 starts a world of four gloo ranks on
the card, a (dp=2, tp=2) mesh: phase 11's ten Experiment-2 steps through
the sharded trainer (``parallel/train.py``: W and bias over 'tp', the
minibatch over 'dp') from phase 11's parameters and indices, against phase
11's losses and weights, then the port's dry run
(``parallel/dryrun.dryrun_multichip``).  Phase 29 drives the port's
experiment and demo drivers (``lqp_py_tpu_torch.experiments`` and
``lqp_py_tpu_torch.demo``) at their published width (B=128, f32, tol 1e-5,
each driver's own n; only depth is cut, and each line says how), with
their own gates, every artifact in a temporary directory: Experiment 1's
six GPU columns at n=1000 (the native C++ column, built from
``native/lqp_native.cpp`` into ``build/``, at n=250), Experiment 2, the
serving and straggler drivers (the early-exit GEMV counted), the
tolerance sweep, the hard set, the Anderson and IP-accuracy sweeps, the
scaling driver on two gloo ranks, the five demos, and the README renderer
on a copy of README.  Phase 7 also
holds the GEMV's rectangular form, the tp step's (128, 1024, 512) block,
against its plain version at 0/50/90% converged, timed beside ``P @ r``.
A failed rank fails the phase.  Every phase raises on failure.  The line
before the last lists each kernel with its launches on its paths, its
error against the plain version, its time beside the plain version's, its
bound and a library yardstick; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero before
printing any result.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

N, B, TOL = 1000, 128, 1e-5
LEAF = 128
N_HARD = 8          # stragglers in the phase-8 batch
N_PAD = 1024        # n=1000 padded to the 128 and to the 256 alignment
N_INEQ = 500        # general inequality rows of phase 18 (ni < n: Schur)
N_CONIC = 300       # phase 20's n: the conic system fits its 1 GiB budget
# Phase 20's gates on the conic backward's relative max-norm errors in dQ
# and dp: f32 against f64 on one residual set (1.7e-6 on one "NVIDIA H100
# 80GB HBM3, 700.00 W"), and conic against 'kkt' at one f32 solution
# (1.8e-4 there: the two rules weigh the weakly active rows differently).
CONIC_F64_GATE, CONIC_KKT_GATE = 1e-4, 2e-3
B_BIG = 65536       # the GEMV's batch above the grid's y limit (phase 7)
B_BENCH = 512       # qpbench's box cells' batch: the mirror's timing (phase 3)
AA_WINDOW = 10      # experiments/experiment_aa.py's first window (phase 14)
# Phase 12's gate on max|x_unrolled - x_fixed_point|: five times the
# 4.542e-05 that one "NVIDIA H100 80GB HBM3, 700.00 W" showed
# (experiments/experiment_1.py's DEV_GATE is 2e-2).
UNROLL_X_GATE = 2.3e-4
# Experiment 2 at experiments/experiment_2.py's defaults.
N_X2, N_FEAT2, N_BATCH2, MINI2, LR2, STEPS2 = 500, 5, 128, 32, 5e-4, 10
# The H100 SXM's published peaks (700 W): float32 outside the tensor cores
# and HBM3.  The bounds use the float32 rate, the type these kernels compute
# in; a 3xTF32 split (three TF32 products per float32 one, 495/3 TFLOP/s)
# would reach about float32 accuracy on the tensor cores and is reported
# beside the block inverse's bound as the rate a faster design could aim at.
F32_FLOPS, TF32X3_FLOPS, HBM_BYTES_S = 67e12, 495e12 / 3, 3.35e12
# The card the script drives; the CPU rehearsal test sets "cpu".
DEVICE = "cuda"
# Phases 22-28: the seed of boxqp_sharded's gradient weights, and each
# world's time limit (start-up included).
W_SEED, PAR_TIMEOUT_S = 7, 300
# Phase 25's condensed OptNet tp=2 runs at n=256 (G = [-I; I]): at n=1000
# each of its iterations would exchange a (128, 2000, 500) f32 block of G
# (512 MB) through the host.
N_COND = 256
# Phase 29: the port's experiment and demo drivers at their published width
# (B=128, f32, tol 1e-5, each driver's own n; Experiment 2 at N_X2...).
# Only depth is cut, and the phase's lines print each cut.  The native C++
# column runs at n=250: at n=1000 its sequential solve of 128 problems
# (37.7 s in exp1_results.json, a capture on another host's CPU) does not
# fit the time.
D29 = {"exp1_n": 1000, "native_n": 250, "serving_n": 500,
       "straggler_n": 1000, "paper_n": 500, "hard_n": 500, "aa_n": 250,
       "aa_batch": 64, "ip_n": 1000, "demo_n": 500, "layer_n": 1000,
       "layer_batch": 32, "scaling_n": 64, "scaling_batch": 8}
# Phase 29's demo gates: the f32 solve against the native C++ solver in
# f64 (3.8e-6 on the card), and the layer demo's KKT and unrolled dp
# against the fixed-point one (1.5e-6 and 1.8e-6).
DEMO_NATIVE_TOL, DEMO_DP_TOL = 1e-3, 1e-3


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _event_ms(fn, reps, queued=False, host_ms=0.1):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls.

    With ``queued`` the stream is first held by a spin kernel long enough
    for the host to enqueue every call (``host_ms`` per call), so the time
    is the device's alone; without it a call whose host side outlasts its
    kernels is timed at the host's pace, as the solver loop sees it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(reps * host_ms * 2e6))    # cycles at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations at the float32
    rate and the bytes at the memory rate."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _gemv_bytes(b, n_act, m, k):
    """Bytes the early-exit GEMV must move for (b, m, k) P with ``n_act``
    active elements: their P and r read, the frozen elements' x_prev read,
    every element's out written (float32)."""
    return 4 * (n_act * (m * k + k) + (b - n_act) * m + b * m)


def _polish_rounds(module, name, fn):
    """``fn()`` and how many polish rounds it ran: calls of the interior
    points' penalty polish ``module.name``, one factorization each (two, or
    three where round 2 narrowly failed on some element)."""
    real, calls = getattr(module, name), []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    setattr(module, name, counted)
    try:
        return fn(), len(calls)
    finally:
        setattr(module, name, real)


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _straggler_data(n, b, n_hard, dev):
    """Phase 8's straggler serving batch (experiments/
    experiment_straggler.py): hard problems, all but ``n_hard`` ridged with
    mean(diag Q) * I into easy ones."""
    from lqp_py_tpu_torch.utils.generators import generate_hard_qp
    hard = generate_hard_qp(n, b, seed=0, dtype=torch.float32, device=dev)
    ridge = hard.Q.diagonal(dim1=-2, dim2=-1).mean(dim=-1)
    is_easy = torch.arange(b, device=dev) < b - n_hard
    Q = hard.Q + torch.where(is_easy, ridge, 0.0)[:, None, None] * torch.eye(
        n, device=dev)
    return (Q, *hard[1:])


def _general_ineq_data(n, b, ni, dev):
    """Phase 18's OptNet problems on ni general inequalities, random around
    a strictly feasible point as tests/test_optnet.py:48-78 builds them."""
    from lqp_py_tpu_torch.ops.precision import highest_matmul_precision
    g18 = torch.Generator(device=dev).manual_seed(18)
    kw = dict(device=dev, dtype=torch.float32)
    L = torch.randn((b, 2 * n, n), generator=g18, **kw)
    with highest_matmul_precision():
        Q = L.mT @ L / (2 * n) + 0.1 * torch.eye(n, **kw)
        del L
        p = torch.randn((b, n), generator=g18, **kw)
        A = torch.randn((b, 1, n), generator=g18, **kw)
        x0 = torch.randn((b, n), generator=g18, **kw)
        rhs = (A @ x0[..., None])[..., 0]
        G = torch.randn((b, ni, n), generator=g18, **kw)
        h = ((G @ x0[..., None])[..., 0] + 0.5
             + torch.rand((b, ni), generator=g18, **kw))
    return Q, p, A, rhs, G, h


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "check needs an NVIDIA GPU")
    from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, OptNetConfig,
                                  boxqp, boxqp_ip, prepare_box_qp,
                                  prepare_qp_gen, qp_eqcon, qp_gen,
                                  qp_optnet, qp_uncon, solve_box_qp,
                                  solve_box_qp_ip, solve_box_qp_prepared,
                                  solve_qp_eqcon, solve_qp_gen,
                                  solve_qp_gen_prepared, solve_qp_optnet,
                                  solve_qp_uncon)
    from lqp_py_tpu_torch.models import box_ip as bip
    from lqp_py_tpu_torch.models import box_qp_grad as grads
    from lqp_py_tpu_torch.models import conic_grad
    from lqp_py_tpu_torch.models import genqp as gq
    from lqp_py_tpu_torch.models import optnet as onet
    from lqp_py_tpu_torch.models import layers
    from lqp_py_tpu_torch.models import train
    from lqp_py_tpu_torch.ops import linalg as lin
    from lqp_py_tpu_torch.ops.kernels import _build
    from lqp_py_tpu_torch.ops.kernels import admm_step as gk
    from lqp_py_tpu_torch.ops.kernels import block_inverse as bk
    from lqp_py_tpu_torch.ops.kernels import mirror as mk
    from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
    from lqp_py_tpu_torch.ops.operator import DENSE
    from lqp_py_tpu_torch.ops.precision import highest_matmul_precision
    from lqp_py_tpu_torch.utils import checkpoint as ckpt
    from lqp_py_tpu_torch.utils.generators import (create_qp_data,
                                                   kkt_residuals)
    from lqp_py_tpu_torch.utils.profiling import timed, trace

    def kkt_of(data, sol):
        return kkt_residuals(*data, sol.x, sol.lams, sol.nus)

    dev = torch.device(DEVICE, 0)
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
    attrs = _build.kernel_attributes("sweep_spd_inverse")
    _check(attrs["local_bytes"] == 0, f"the leaf kernel spills to local "
           f"memory: {attrs}")
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((B, 2 * LEAF, LEAF), generator=g, device=dev)
    with highest_matmul_precision():
        H = (a.mT @ a) / (2 * LEAF) + torch.eye(LEAF, device=dev)
        # The recursion hands the leaf leading-block views, read in place.
        a2 = torch.randn((B, 4 * LEAF, 2 * LEAF), generator=g, device=dev)
        view = ((a2.mT @ a2) / (4 * LEAF))[:, :LEAF, :LEAF]
    view.diagonal(dim1=-2, dim2=-1).add_(1.0)
    same_view = torch.equal(sk.sweep_spd_inverse(view),
                            sk.sweep_spd_inverse(view.contiguous()))
    _check(same_view, "the leaf kernel on a leading-block view differs from "
           "the kernel on its contiguous copy")
    del a2, view
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
    # An ill-conditioned leaf (cond 1e4): the kernel's error against the
    # float64 inverse at most twice the plain version's.
    q, _ = torch.linalg.qr(torch.randn((B, LEAF, LEAF), generator=g,
                                       device=dev, dtype=torch.float64))
    lam = torch.logspace(-4, 0, LEAF, dtype=torch.float64, device=dev)
    Hc64 = (q * lam) @ q.mT
    Hc = (0.5 * (Hc64 + Hc64.mT)).float()
    invc = torch.linalg.inv(Hc.double())
    errc_k = (sk.sweep_spd_inverse(Hc).double() - invc).abs().max().item()
    errc_r = (sk.sweep_spd_inverse_ref(Hc).double() - invc).abs().max().item()
    _check(errc_k <= 2 * errc_r, f"cond 1e4 leaf: kernel error {errc_k:.3e} "
           f"against plain {errc_r:.3e}")
    del q, Hc64, Hc, invc
    # Turns: plain, kernel, kernel, plain (after one warm-up each); the
    # kernel on the device alone (stream held) and at the host's pace.
    sk.sweep_spd_inverse(H), sk.sweep_spd_inverse_ref(H)
    t_p1 = _event_ms(lambda: sk.sweep_spd_inverse_ref(H), 5)
    t_k1 = _event_ms(lambda: sk.sweep_spd_inverse(H), 50, queued=True)
    h_k1 = _event_ms(lambda: sk.sweep_spd_inverse(H), 50)
    h_k2 = _event_ms(lambda: sk.sweep_spd_inverse(H), 50)
    t_k2 = _event_ms(lambda: sk.sweep_spd_inverse(H), 50, queued=True)
    t_p2 = _event_ms(lambda: sk.sweep_spd_inverse_ref(H), 5)
    kernel_ms, plain_ms = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
    paced_ms = (h_k1 + h_k2) / 2

    def chol_inv(X):
        # cholesky_ex: no read of the error flags, so the call is
        # enqueued without waiting for the card (as the leaf is).
        return torch.cholesky_inverse(torch.linalg.cholesky_ex(X)[0])

    # The library yardstick: the median of five warm readings, in turns
    # with the leaf, each on the device alone (stream held).
    for _ in range(3):
        chol_inv(H)
    turns3 = [(_event_ms(lambda: sk.sweep_spd_inverse(H), 20, queued=True),
               _event_ms(lambda: chol_inv(H), 20, queued=True, host_ms=1.0))
              for _ in range(5)]
    leaf_lib_ms = statistics.median(lib for _, lib in turns3)
    # An SPD inverse needs about n^3 flops (Cholesky, triangular inverse and
    # the symmetric product, n^3/3 each); each matrix read and written once.
    leaf_bound = _bound(B * LEAF ** 3, 2 * 4 * B * LEAF ** 2)
    print(f"phase 3 leaf ({B},{LEAF},{LEAF}) f32: max|kernel-plain| "
          f"{max_abs:.3e} (rel {rel:.3e} <= 1e-4); |H Hinv - I|max kernel "
          f"{res_k:.3e}, plain {res_r:.3e} (<= 1e-4); |Hinv - inv_f64|max "
          f"kernel {err_k:.3e}, plain {err_r:.3e}; cond 1e4: kernel "
          f"{errc_k:.3e}, plain {errc_r:.3e} (ratio {errc_k / errc_r:.3f} "
          f"<= 2); leading-block view bitwise the contiguous copy; "
          f"{attrs['regs']} registers, "
          f"{attrs['local_bytes']} local bytes; device time kernel "
          f"{kernel_ms:.4f} ms ({t_k1:.4f}, {t_k2:.4f}), host-paced "
          f"{paced_ms:.4f} ms ({h_k1:.4f}, {h_k2:.4f}), plain "
          f"{plain_ms:.4f} ms ({t_p1:.4f}, {t_p2:.4f}), "
          f"cholesky_inverse(cholesky_ex) median {leaf_lib_ms:.4f} ms of "
          f"five warm readings in turns with the leaf, leaf/library ms ["
          + ", ".join(f"{k:.4f}/{c:.4f}" for k, c in turns3)
          + f"]; bound {leaf_bound[0]:.4f} ms by {leaf_bound[1]}")

    # The leaf writing in place over an inner diagonal block of a
    # (B, N_PAD, N_PAD) stack, as the recursion runs it: bitwise the
    # kernel's new output (Hk), nothing outside the block written, and
    # within phase 3's tolerance of the plain leaf in place.
    o3 = N_PAD // 2 - LEAF
    blk = (slice(None), slice(o3, o3 + LEAF), slice(o3, o3 + LEAF))
    stack = torch.randn((B, N_PAD, N_PAD), generator=g, device=dev)
    stack[blk] = H
    want3, plain3 = stack.clone(), stack.clone()
    want3[blk] = Hk
    sk.sweep_spd_inverse_ref(plain3[blk], out=plain3[blk])
    sk.sweep_spd_inverse(stack[blk], out=stack[blk])
    _check(torch.equal(stack, want3), "the leaf kernel in place over a "
           "diagonal block differs from its new output, or wrote outside it")
    rel_in = ((stack[blk] - plain3[blk]).abs().max()
              / plain3[blk].abs().max()).item()
    _check(rel_in <= 1e-4, f"leaf in place vs plain leaf in place: relative "
           f"{rel_in:.3e}")
    del stack, want3, plain3

    # The recursion's mirror on the blocks an N_PAD inverse mirrors (one
    # per inner node: the top-right block transposed into the bottom-left),
    # at the benchmark's batch, against its plain version bitwise.  The
    # plain version is PyTorch's own transposed copy, so it is also the
    # library yardstick.  Turns: plain, kernel, kernel, plain.
    nodes = []

    def inner(o, n):
        if n > LEAF:
            h = (n // LEAF // 2) * LEAF
            nodes.append((o, n, h))
            inner(o, h)
            inner(o + h, n - h)

    inner(0, N_PAD)

    def mirrors(fn, W):
        for o, n, h in nodes:
            fn(W[:, o:o + h, o + h:o + n], W[:, o + h:o + n, o:o + h])

    Wk = torch.randn((B_BENCH, N_PAD, N_PAD), generator=g, device=dev)
    Wp = Wk.clone()
    m0 = mk.LAUNCHES
    mirrors(mk.mirror_block, Wk)
    mirrors(mk.mirror_block_ref, Wp)
    _check(mk.LAUNCHES - m0 == len(nodes), f"{mk.LAUNCHES - m0} mirror "
           f"launches for {len(nodes)} blocks")
    mirror_err = (Wk - Wp).abs().max().item()
    _check(torch.equal(Wk, Wp), f"the mirror kernel differs from its plain "
           f"version (max {mirror_err:.3e}) or wrote outside its blocks")
    t_mp1 = _event_ms(lambda: mirrors(mk.mirror_block_ref, Wp), 5,
                      queued=True, host_ms=0.3)
    t_mk1 = _event_ms(lambda: mirrors(mk.mirror_block, Wk), 20, queued=True,
                      host_ms=0.3)
    t_mk2 = _event_ms(lambda: mirrors(mk.mirror_block, Wk), 20, queued=True,
                      host_ms=0.3)
    t_mp2 = _event_ms(lambda: mirrors(mk.mirror_block_ref, Wp), 5,
                      queued=True, host_ms=0.3)
    del Wk, Wp
    mirror_ms, mirror_plain_ms = (t_mk1 + t_mk2) / 2, (t_mp1 + t_mp2) / 2
    # Each element of a block read once and written once.
    mirror_bytes = 2 * 4 * B_BENCH * sum(h * (n - h) for _, n, h in nodes)
    mirror_bound = _bound(0, mirror_bytes)
    print(f"phase 3 mirror ({B_BENCH},{N_PAD},{N_PAD}) f32, the "
          f"{len(nodes)} blocks of one inverse ("
          + ", ".join(f"{h}x{n - h}" for _, n, h in nodes) + "): bitwise "
          f"the plain version; leaf in place over a diagonal block bitwise "
          f"its new output, vs the plain leaf in place rel {rel_in:.3e} "
          f"(<= 1e-4); device time kernel {mirror_ms:.4f} ms ({t_mk1:.4f}, "
          f"{t_mk2:.4f}), plain (out.copy_(src.mT)) {mirror_plain_ms:.4f} ms "
          f"({t_mp1:.4f}, {t_mp2:.4f}); bound {mirror_bound[0]:.4f} ms by "
          f"{mirror_bound[1]} ({mirror_bytes / mirror_ms / 1e6:.0f} GB/s)")

    # 4. One factorization at the serving shape (bench.py's probe).
    data0 = create_qp_data(N, B, seed=0, dtype=torch.float32, device=dev)
    eyeN = torch.eye(N, device=dev)
    Hq = data0.Q + eyeN
    with highest_matmul_precision():
        before, m0 = sk.LAUNCHES, mk.LAUNCHES
        Hi = lin.spd_inverse_fast(Hq)
        leaf_calls, mirror_calls = sk.LAUNCHES - before, mk.LAUNCHES - m0
        res = (Hq @ Hi - eyeN).abs().max().item()
        fact_ms = _event_ms(lambda: lin.spd_inverse_fast(Hq), 3)
    del Hi
    _check(res < 1e-4, f"factorization residual {res:.3e}")
    _check(leaf_calls == N_PAD // LEAF,
           f"{leaf_calls} leaf launches, expected {N_PAD // LEAF}")
    _check(mirror_calls == len(nodes),
           f"{mirror_calls} mirror launches, expected {len(nodes)}")
    print(f"phase 4 spd_inverse_fast(Q + I) B={B} n={N} f32: |H Hinv - I|max "
          f"{res:.3e} (< 1e-4), {leaf_calls} leaf launches, {mirror_calls} "
          f"mirror launches, {fact_ms:.3f} ms")

    # 5-6: the serving path; only its kernel launches are counted.
    cfg = BoxQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False)
    sk.LAUNCHES = mk.LAUNCHES = 0

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
    x64_5 = sol64.x
    x5, it5 = direct0.x, direct0.iterations     # phases 22-23 hold to these
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
    launches, mirrors6 = sk.LAUNCHES, mk.LAUNCHES
    print(f"phase 6 serving: prepare {prep_ms:.2f} ms; requests "
          f"[{'; '.join(lines)}]; first request vs direct solve "
          f"{dprep:.3e} (<= 1e-6); {launches} leaf and {mirrors6} mirror "
          f"launches")
    _check(launches > 0, "the serving path launched no sweep kernel")
    # Every factorization is one N_PAD inverse: its leaves and its mirrors.
    _check(mirrors6 * leaf_calls == launches * len(nodes),
           f"serving: {mirrors6} mirrors for {launches} leaves, expected "
           f"{len(nodes)} per {leaf_calls}")
    _check(gk.LAUNCHES == 0, "the lock-step path launched the early-exit "
           "GEMV")
    del data, prep, prev, sol

    # 7. Early-exit GEMV vs plain at the shape the solver gives it, with a
    # fixed share of the batch converged.  Turns: plain, kernel, kernel,
    # plain (after one warm-up each).
    attrs7 = _build.kernel_attributes("gemv_early_exit")
    _check(attrs7["local_bytes"] == 0, f"the GEMV kernel spills to local "
           f"memory: {attrs7}")
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

            if frac == 0.0:
                # Nothing converged: one batched matmul is the function.
                # Kernel and call in turns, so that one run settles which
                # is faster.
                def call():
                    P7 @ r7[..., None]

                call()
                vs_call = [(_event_ms(kern, 20, True),
                            _event_ms(call, 20, True)) for _ in range(3)]
                gemv_lib_ms = sum(c for _, c in vs_call) / len(vs_call)
                gemv_turn_ms = sum(k for k, _ in vs_call) / len(vs_call)
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
    # The rectangular form, the tp=2 early-exit step's block of P: (B, m, k)
    # = (128, 1024, 512), 0/50/90% converged, in turns with its plain
    # version (device time), beside P @ r (one batched matmul).
    M7, K7 = N_PAD, N_PAD // 2
    P7r = torch.randn((B, M7, K7), generator=g7, device=dev)
    r7r = torch.randn((B, K7), generator=g7, device=dev)
    rect = {}
    with highest_matmul_precision():
        for frac in (0.0, 0.5, 0.9):
            conv = torch.zeros(B, dtype=torch.bool, device=dev)
            conv[order[:round(frac * B)]] = True
            out = gk.gemv_early_exit(P7r, r7r, x7, conv)
            ref7 = gk.gemv_early_exit_ref(P7r, r7r, x7, conv)
            torch.cuda.synchronize()
            _check(tuple(out.shape) == (B, M7)
                   and torch.equal(out[conv], x7[conv]),
                   f"rectangular, {frac:.0%} converged: frozen rows are not "
                   f"x_prev")
            act = ~conv
            err = (out[act] - ref7[act]).abs().max().item()
            rel = err / ref7[act].abs().max().item()
            _check(rel <= 1e-5, f"rectangular, {frac:.0%} converged: kernel "
                   f"vs plain relative difference {rel:.3e}")

            def kern_r():
                gk.gemv_early_exit(P7r, r7r, x7, conv)

            def plain_r():
                gk.gemv_early_exit_ref(P7r, r7r, x7, conv)

            def call_r():
                P7r @ r7r[..., None]

            call_r()
            t_p1, t_k1, t_k2, t_p2, t_c = (_event_ms(f, 20, True) for f in (
                plain_r, kern_r, kern_r, plain_r, call_r))
            n_act = int(act.sum())
            rect[frac] = dict(
                ms=(t_k1 + t_k2) / 2, plain_ms=(t_p1 + t_p2) / 2,
                library_ms=t_c, err=err, active=n_act,
                bound=_bound(2 * n_act * M7 * K7,
                             _gemv_bytes(B, n_act, M7, K7)))
            print(f"phase 7 early-exit GEMV, rectangular ({B},{M7},{K7}) "
                  f"f32, {B - n_act}/{B} converged: max|kernel-plain| "
                  f"{err:.3e} (rel {rel:.3e} <= 1e-5), frozen rows bitwise; "
                  f"device time kernel {rect[frac]['ms']:.4f} ms ({t_k1:.4f}, "
                  f"{t_k2:.4f}), plain {rect[frac]['plain_ms']:.4f} ms "
                  f"({t_p1:.4f}, {t_p2:.4f}), P @ r {t_c:.4f} ms; bound "
                  f"{rect[frac]['bound'][0]:.4f} ms by "
                  f"{rect[frac]['bound'][1]} (P and r of the active "
                  f"elements, x_prev of the frozen, out of all)")
    del P7r, r7r, ref7
    # A batch above the grid's y limit (65535) runs in chunks: B_BIG
    # elements of n=8, a third of them converged.
    Pb = torch.randn((B_BIG, 8, 8), generator=g7, device=dev)
    rb = torch.randn((B_BIG, 8), generator=g7, device=dev)
    xb = torch.randn((B_BIG, 8), generator=g7, device=dev)
    convb = torch.zeros(B_BIG, dtype=torch.bool, device=dev)
    convb[torch.randperm(B_BIG, generator=g7, device=dev)[:B_BIG // 3]] = True
    with highest_matmul_precision():
        gb0 = gk.LAUNCHES
        outb = gk.gemv_early_exit(Pb, rb, xb, convb)
        launches_big = gk.LAUNCHES - gb0
        refb = gk.gemv_early_exit_ref(Pb, rb, xb, convb)
    torch.cuda.synchronize()
    _check(launches_big == 1, f"{launches_big} GEMV launches at B={B_BIG}")
    _check(torch.equal(outb[convb], xb[convb]),
           f"B={B_BIG}: frozen rows are not x_prev")
    actb = ~convb
    errb = (outb[actb] - refb[actb]).abs().max().item()
    relb = errb / refb[actb].abs().max().item()
    _check(relb <= 1e-5, f"B={B_BIG}: kernel vs plain relative difference "
           f"{relb:.3e}")
    print(f"phase 7 early-exit GEMV at B={B_BIG} (above the grid's 65535), "
          f"n=8, {int(convb.sum())} converged: max|kernel-plain| {errb:.3e} "
          f"(rel {relb:.3e} <= 1e-5), frozen rows bitwise")
    del Pb, rb, xb, outb, refb
    # Bytes the kernel must move with none converged: all of P, r and out.
    bytes0 = _gemv_bytes(B, B, N_PAD, N_PAD)
    gbps0 = bytes0 / (gemv[0.0]["ms"] * 1e-3) / 1e9
    ratio90 = gemv[0.9]["ms"] / gemv[0.0]["ms"]
    active90 = B - round(0.9 * B)
    gemv_bound = _bound(2 * B * N_PAD ** 2, bytes0)
    print(f"phase 7 kernel at 0% converged: {gbps0:.1f} GB/s "
          f"({bytes0 / 1e6:.1f} MB); {attrs7['regs']} registers, "
          f"{attrs7['local_bytes']} local bytes; 90%/0% device time ratio "
          f"{ratio90:.3f} (< 0.5) against the active share {active90}/{B} = "
          f"{active90 / B:.3f}, host-paced "
          f"{gemv[0.9]['paced_ms'] / gemv[0.0]['paced_ms']:.3f}; bound "
          f"{gemv_bound[0]:.4f} ms by {gemv_bound[1]}; in turns with P @ r "
          f"(one batched matmul), kernel/call ms ["
          + ", ".join(f"{k:.4f}/{c:.4f}" for k, c in vs_call)
          + f"]: kernel {gemv_turn_ms:.4f}, call {gemv_lib_ms:.4f}, ratio "
          f"{gemv_turn_ms / gemv_lib_ms:.3f} (the kernel is "
          f"{'slower' if gemv_turn_ms > gemv_lib_ms else 'no slower'})")
    _check(ratio90 < 0.5, f"90%-converged GEMV takes {ratio90:.3f} of the "
           f"0% time: frozen panels are read")

    # 8. Straggler serving batch (experiments/experiment_straggler.py):
    # hard problems, all but N_HARD ridged with mean(diag Q) * I.
    data8 = _straggler_data(N, B, N_HARD, dev)
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
    # Phase 26 holds the tp=2 straggler solves to these.
    ref = {"x8": sols8["lock-step"].x.cpu(),
           "it8": {k: v[-1][1]["it"] for k, v in runs8.items()},
           "q8_sum": float(data8[0].double().sum())}

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

    # 9. The whole-matrix block-sweep inverse at its own entry point (no
    # solver calls it), on its input contract: an equilibrated SPD stack,
    # Q + I of the serving problems at n = 1024, Jacobi-scaled.
    H9 = create_qp_data(N_PAD, B, seed=0, dtype=torch.float32,
                        device=dev).Q
    H9.diagonal(dim1=-2, dim2=-1).add_(1.0)
    d9 = H9.diagonal(dim1=-2, dim2=-1).rsqrt()
    H9 = H9 * d9[:, :, None] * d9[:, None, :]
    del d9
    with highest_matmul_precision():
        bk.LAUNCHES = 0
        Hk9 = bk.block_spd_inverse(H9)
        torch.cuda.synchronize()
        launches9 = bk.LAUNCHES
        _check(launches9 == 1, f"{launches9} block-inverse launches for one "
               f"call")
        Hr9 = bk.block_spd_inverse_ref(H9)
        max_abs9 = (Hk9 - Hr9).abs().max().item()
        rel9 = max_abs9 / Hr9.abs().max().item()
        H64 = H9.double()
        eye64 = torch.eye(N_PAD, dtype=torch.float64, device=dev)
        res9_k = (H64 @ Hk9.double() - eye64).abs().max().item()
        res9_r = (H64 @ Hr9.double() - eye64).abs().max().item()
        sym9 = torch.equal(Hk9, Hk9.mT)
        _check(rel9 <= 1e-4, f"block inverse kernel vs plain relative "
               f"difference {rel9:.3e}")
        _check(res9_k <= 1e-4 and res9_r <= 1e-4, f"block inverse residuals "
               f"kernel {res9_k:.3e}, plain {res9_r:.3e}")
        inv9 = torch.linalg.inv(H64)
        err9_k = (Hk9.double() - inv9).abs().max().item()
        err9_r = (Hr9.double() - inv9).abs().max().item()
        del inv9
        fns9 = {"kernel": lambda: bk.block_spd_inverse(H9),
                "plain": lambda: bk.block_spd_inverse_ref(H9),
                "recursion": lambda: lin.spd_inverse_fast(
                    H9, equilibrate=False),
                "cholesky_inverse": lambda: chol_inv(H9)}
        reps9 = {"kernel": 3, "plain": 1, "recursion": 3,
                 "cholesky_inverse": 2}
        for fn in fns9.values():
            fn()
        t9 = {k: [] for k in fns9}
        for order in (list(fns9), list(fns9)[::-1]):
            for k in order:
                t9[k].append(_event_ms(fns9[k], reps9[k]))
        # Kernel and recursion in turns, so that one run settles which is
        # faster.
        vs_rec = [(_event_ms(fns9["kernel"], 3),
                   _event_ms(fns9["recursion"], 3)) for _ in range(3)]
    del H64, eye64, Hk9, Hr9
    _check(sym9, "the block inverse's output is not symmetric")
    ms9 = {k: sum(v) / len(v) for k, v in t9.items()}
    # Device-memory traffic the kernel's design issues per call, L2 hits
    # included, in 128 x 128 f32 tiles per matrix: per step the pivot tile
    # (read, write), the transposed panel rows below it (read, write), C read
    # and W written (step 3), W[I] read and per upper tile C[J] read and M
    # read and written (step 4), W read and V written (step 5); around the
    # steps the upper triangle copied in, mirrored and negated.
    nb9 = N_PAD // LEAF
    tiles9 = 0
    for kb in range(nb9):
        m9 = nb9 - 1
        tiles9 += 2 + 2 * (nb9 - 1 - kb) + 2 * m9 + (m9 + 3 * m9 * (m9 + 1)
                                                        // 2) + 2 * m9
    upper9 = nb9 * (nb9 + 1) // 2
    tiles9 += 2 * upper9 + 2 * (upper9 - nb9) + 3 * nb9 + 2 * upper9
    bytes9 = B * tiles9 * 4 * LEAF * LEAF
    bytes9_ms = bytes9 / HBM_BYTES_S * 1e3
    attrs9 = _build.kernel_attributes("block_spd_inverse")
    # n^3 flops per SPD inverse, as for the leaf (the unsymmetric sweep
    # does 2n^3: that is the design's cost, not the function's).
    block_bound = _bound(B * N_PAD ** 3, 2 * 4 * B * N_PAD ** 2)
    block_bound_3xtf32 = B * N_PAD ** 3 / TF32X3_FLOPS * 1e3
    del H9
    print(f"phase 9 block inverse ({B},{N_PAD},{N_PAD}) f32: "
          f"{launches9} launch; max|kernel-plain| {max_abs9:.3e} (rel "
          f"{rel9:.3e} <= 1e-4); |H Hinv - I|max kernel {res9_k:.3e}, plain "
          f"{res9_r:.3e} (<= 1e-4); |Hinv - inv_f64|max kernel {err9_k:.3e}, "
          f"plain {err9_r:.3e}; symmetric; {attrs9['regs']} registers, "
          f"{attrs9['local_bytes']} local bytes; ms " + ", ".join(
              f"{k} {ms9[k]:.4f} ({', '.join(f'{t:.4f}' for t in t9[k])})"
              for k in fns9) + f"; bound {block_bound[0]:.4f} ms by "
          f"{block_bound[1]} (n^3 B flops at {F32_FLOPS / 1e12:g} TFLOP/s; "
          f"{block_bound_3xtf32:.4f} ms at the 3xTF32 rate); the design "
          f"moves {bytes9 / 1e9:.3f} GB per call ({bytes9_ms:.4f} ms at "
          f"{HBM_BYTES_S / 1e12:g} TB/s, L2 hits included); in turns with "
          f"the recursion, kernel/recursion ms ["
          + ", ".join(f"{k:.4f}/{r:.4f}" for k, r in vs_rec) + "] (the "
          f"kernel is {'faster' if all(k < r for k, r in vs_rec) else 'not faster'}"
          f" in every turn)")

    # 10. bench.py's forward+backward: boxqp at B=128, n=1000, gradients
    # with respect to Q and p of sum(w * x), w from a numpy seed.
    data10 = create_qp_data(N, B, seed=0, dtype=torch.float32, device=dev)
    Q10, p10, A10, b10, lb10, ub10 = data10
    Q10.requires_grad_(True)
    p10.requires_grad_(True)
    w10 = torch.as_tensor(np.random.default_rng(10).standard_normal((B, N)),
                          dtype=torch.float32, device=dev)
    cfg10 = BoxQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False)
    leaves10 = N_PAD // LEAF
    bwd10 = {}                  # the last backward's mirror launches

    def fwd_bwd(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = boxqp(Q10, p10, A10, b10, lb10, ub10, config=cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s0, m0 = sk.LAUNCHES, mk.LAUNCHES
        gQ, gp = torch.autograd.grad((w10 * x).sum(), (Q10, p10))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bwd10["mirrors"] = mk.LAUNCHES - m0
        return (x.detach(), gQ, gp, sk.LAUNCHES - s0,
                ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t2 - t0) * 1e3))

    sk.LAUNCHES = mk.LAUNCHES = 0
    x10, gQ10, gp10, bwd_leaves, _ = fwd_bwd(cfg10)
    launches10, mirrors10 = sk.LAUNCHES, mk.LAUNCHES
    bwd_mirrors10 = bwd10["mirrors"]
    _check(bwd_leaves == leaves10, f"{bwd_leaves} leaf launches in the "
           f"fixed-point backward, expected {leaves10}")
    # The backward's solve-only form mirrors every inner node but its top
    # one, unless it inverts the whole (N_PAD <= 2 LEAF); the forward's
    # factorizations are whole inverses.
    want10 = len(nodes) - (N_PAD > 2 * LEAF)
    _check(bwd_mirrors10 == want10, f"{bwd_mirrors10} mirror launches in "
           f"the fixed-point backward, expected {want10}")
    _check((mirrors10 - bwd_mirrors10) * leaves10
           == (launches10 - bwd_leaves) * len(nodes),
           f"forward: {mirrors10 - bwd_mirrors10} mirrors for "
           f"{launches10 - bwd_leaves} leaves")
    _check(all(bool(torch.isfinite(t).all()) for t in (x10, gQ10, gp10)),
           "x or a gradient not finite")
    _check(tuple(gQ10.shape) == (B, N, N) and tuple(gp10.shape) == (B, N),
           "gradient shapes")
    # The forward's solution (the layer returns x only): the same solve.
    sol10 = solve_box_qp(*(t.detach() for t in data10), config=cfg10)
    n_conv = int(sol10.converged.sum())
    _check(n_conv == B, f"flagship forward: {n_conv}/{B} converged")
    dx_layer = (sol10.x - x10).abs().max().item()
    _check(dx_layer <= 1e-6, f"layer x vs solve x differ by {dx_layer:.3e}")
    # The float32 backward on the card against the float64 backward
    # (Cholesky) fed the same float32 residual set cast to float64.
    res10 = dict(x=sol10.x, u=sol10.u, lams=sol10.lams, nus=sol10.nus,
                 Q=Q10.detach(), A=A10, lb=lb10, ub=ub10, rho=sol10.rho)
    g32 = grads.box_qp_grad_fixed_point(w10, **res10,
                                        reg=cfg10.backward_reg)
    g64 = grads.box_qp_grad_fixed_point(
        w10.double(), **{k: v.double() for k, v in res10.items()},
        reg=cfg10.backward_reg)
    rel_dp = ((g32[1].double() - g64[1]).abs().max()
              / g64[1].abs().max()).item()
    rel_dQ = ((g32[0].double() - g64[0]).abs().max()
              / g64[0].abs().max()).item()
    # The layer's autograd gradients against the direct call on the same
    # residual set: the saved residuals, the outputs' order and layout.
    wire_dp = ((gp10 - g32[1]).abs().max() / g32[1].abs().max()).item()
    wire_dQ = ((gQ10 - g32[0]).abs().max() / g32[0].abs().max()).item()
    del g32, g64, res10
    _check(wire_dp <= 1e-5 and wire_dQ <= 1e-5, f"layer vs direct backward: "
           f"relative max|ddp| {wire_dp:.3e}, max|ddQ| {wire_dQ:.3e}")
    _check(rel_dp <= 1e-4, f"f32 vs f64 backward: relative max|ddp| "
           f"{rel_dp:.3e}")
    _, gQk, gpk, kkt_leaves, _ = fwd_bwd(dataclasses.replace(
        cfg10, backward="kkt"))
    dkkt_p = (gpk - gp10).abs().max().item()
    dkkt_Q = (gQk - gQ10).abs().max().item()
    del gQk, gpk
    times10 = [fwd_bwd(cfg10)[-1] for _ in range(3)]
    print(f"phase 10 flagship forward+backward (B={B}, n={N}, f32, tol "
          f"{TOL:g}, fixed_point, d/dQ and d/dp of sum(w x)): {n_conv}/{B} "
          f"converged in {sol10.iterations} iterations; {launches10} leaf "
          f"launches, {bwd_leaves} in the backward (= {leaves10}); "
          f"{mirrors10} mirror launches, {bwd_mirrors10} in the backward; "
          f"x and "
          f"both gradients finite; max|dp| {gp10.abs().max().item():.4e}; "
          f"layer vs direct backward: relative max|ddp| {wire_dp:.3e}, "
          f"max|ddQ| {wire_dQ:.3e} (<= 1e-5); f32 vs f64 backward on one "
          f"residual set: relative max|ddp| {rel_dp:.3e} (<= 1e-4), max|ddQ| "
          f"{rel_dQ:.3e}; kkt backward "
          f"({kkt_leaves} leaves) vs fixed_point: max|ddp| {dkkt_p:.3e}, "
          f"max|ddQ| {dkkt_Q:.3e}; ms forward/backward/total " + "; ".join(
              f"{f:.2f}/{b_:.2f}/{t:.2f}" for f, b_, t in times10))
    del sol10

    # 11. Experiment-2 trainer: LinearQP + boxqp, SGD on minibatches of the
    # numpy-seeded index matrix, default BoxQPConfig at tol 1e-5.
    rng11 = np.random.default_rng(11)
    data11 = create_qp_data(N_X2, N_BATCH2, seed=0, dtype=torch.float32,
                            device=dev)

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    feats11 = on_dev(rng11.standard_normal((N_BATCH2, N_FEAT2)))
    beta11 = on_dev(rng11.standard_normal((N_FEAT2, N_X2)))
    sel11 = np.stack([rng11.choice(N_BATCH2, MINI2, replace=False)
                      for _ in range(STEPS2)])
    with highest_matmul_precision():
        p_true11 = feats11 @ beta11
    params11 = train.init_params(N_FEAT2, N_X2, generator=torch.Generator(
        device=dev).manual_seed(11), device=dev)
    W0 = params11.W.detach().clone()
    step11 = train.make_train_step(BoxQPConfig(eps_abs=TOL, eps_rel=TOL),
                                   lr=LR2)
    full11 = (feats11, data11.Q, p_true11, data11.A, data11.b, data11.lb,
              data11.ub)
    bwd_leaves11 = []
    bwd_fn = layers._boxqp_bwd

    def counted_bwd(*args, **kw):
        s0 = sk.LAUNCHES
        out = bwd_fn(*args, **kw)
        bwd_leaves11.append(sk.LAUNCHES - s0)
        return out

    layers._boxqp_bwd = counted_bwd
    losses11, ms11 = [], []
    try:
        sk.LAUNCHES = 0
        for idx in sel11:
            mb = [v[torch.as_tensor(idx, device=dev)] for v in full11]
            (params11, loss), ms = _wall_ms(lambda: step11(params11, *mb))
            losses11.append(loss.item())
            ms11.append(ms)
        launches11 = sk.LAUNCHES
    finally:
        layers._boxqp_bwd = bwd_fn
    leaves11 = -(-N_X2 // LEAF)
    _check(all(np.isfinite(losses11)), f"training losses {losses11}")
    _check(bwd_leaves11 == [leaves11] * STEPS2,
           f"leaf launches per backward {bwd_leaves11}, expected "
           f"{leaves11} each")
    moved = (params11.W.detach() - W0).abs().max().item()
    _check(moved > 0, "the trainer's parameters did not move")
    print(f"phase 11 Experiment-2 trainer (n_x={N_X2}, {N_FEAT2} features, "
          f"minibatch {MINI2} of {N_BATCH2}, SGD lr {LR2:g}, tol {TOL:g}): "
          f"{STEPS2} steps, {launches11} leaf launches, {leaves11} per "
          f"backward; max|dW| {moved:.3e}; loss per step "
          f"[{', '.join(f'{v:.5f}' for v in losses11)}]; ms per step "
          f"[{', '.join(f'{v:.2f}' for v in ms11)}]")
    # Phase 28's yardstick: the sharded trainer starts where this one did.
    ref["train11"] = {"feats": feats11.cpu(), "p_true": p_true11.cpu(),
                      "sel": sel11, "W0": W0.cpu(),
                      "W": params11.W.detach().cpu(),
                      "bias": params11.bias.detach().cpu(),
                      "losses": np.array(losses11),
                      "q_sum": float(data11.Q.double().sum())}

    # 12. Experiment 1's ADMM_Unroll mode (experiments/experiment_1.py):
    # boxqp(unroll=True, unroll_iters=60, adaptive_rho=False) on phase 10's
    # Q, p and w, gradients with respect to Q and p, held against phase
    # 10's fixed-point x and gradients.
    cfg12 = BoxQPConfig(eps_abs=TOL, eps_rel=TOL, unroll=True,
                        symmetrize=False, unroll_iters=60,
                        adaptive_rho=False)
    solves12 = []
    solve_fn = lin.kkt_solve_cached

    def counted_solve(*args):
        solves12.append(1)
        return solve_fn(*args)

    def unrolled():
        solves12.clear()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        s0 = sk.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = boxqp(Q10, p10, A10, b10, lb10, ub10, config=cfg12)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s1 = sk.LAUNCHES
        gQ, gp = torch.autograd.grad((w10 * x).sum(), (Q10, p10))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() - base_mem
        return (x.detach(), gQ, gp, len(solves12), s1 - s0,
                sk.LAUNCHES - s1, peak,
                ((t1 - t0) * 1e3, (t2 - t1) * 1e3))

    lin.kkt_solve_cached = counted_solve
    try:
        sk.LAUNCHES = 0
        x12, gQ12, gp12, it12, fwd_leaves12, bwd_leaves12, peak12, _ = (
            unrolled())
        launches12 = sk.LAUNCHES
        times12 = [unrolled()[-1] for _ in range(2)]
    finally:
        lin.kkt_solve_cached = solve_fn
    _check(fwd_leaves12 == leaves10 and bwd_leaves12 == 0,
           f"unrolled: {fwd_leaves12} leaf launches in the forward, "
           f"{bwd_leaves12} in the backward (want {leaves10} and 0)")
    _check(all(bool(torch.isfinite(t).all()) for t in (x12, gQ12, gp12)),
           "unrolled: x or a gradient not finite")
    dx12 = (x12 - x10).abs().max().item()

    def rel_fro(a, b):
        return ((a - b).norm() / b.norm()).item()

    # With symmetrize=False the unrolled dQ differentiates each entry of Q
    # on its own, while the fixed-point backward returns the gradient on
    # the symmetric matrices (its symmetric part); the two agree on every
    # symmetric direction, so their symmetric parts are compared.
    def sym(M):
        return 0.5 * (M + M.mT)

    rel_dQ12, rel_dp12 = rel_fro(sym(gQ12), sym(gQ10)), rel_fro(gp12, gp10)
    raw_dQ12 = rel_fro(gQ12, gQ10)
    _check(dx12 <= UNROLL_X_GATE, f"unrolled vs fixed-point x: "
           f"{dx12:.3e} > {UNROLL_X_GATE:g}")
    _check(rel_dQ12 <= 5e-2 and rel_dp12 <= 5e-2,
           f"unrolled vs fixed-point gradients: relative Frobenius sym(dQ) "
           f"{rel_dQ12:.3e}, dp {rel_dp12:.3e} (> 5e-2)")
    print(f"phase 12 Experiment-1 unrolled forward+backward (B={B}, n={N}, "
          f"f32, tol {TOL:g}, unroll_iters 60, adaptive rho off): "
          f"{it12} iterations before done; {fwd_leaves12} leaf launches in "
          f"the forward, {bwd_leaves12} in the backward; max|x - x_fp| "
          f"{dx12:.3e} (<= {UNROLL_X_GATE:g}); relative Frobenius vs "
          f"fixed point sym(dQ) {rel_dQ12:.3e}, dp {rel_dp12:.3e} (<= 5e-2)"
          f", raw dQ {raw_dQ12:.3e}; "
          f"peak memory above the inputs {peak12 / 2**30:.3f} GiB; ms "
          f"forward/backward " + "; ".join(
              f"{f:.2f}/{b_:.2f}" for f, b_ in times12))
    del x12, gQ12, gp12, data10, Q10, p10, gQ10, gp10, x10

    # 13. Polish and the Cholesky KKT mode on phase 5's serving requests.
    cfg_pol = dataclasses.replace(cfg, polish=True)
    s0 = sk.LAUNCHES
    plain13, plain13_ms = _wall_ms(lambda: solve_box_qp(*data0, config=cfg))
    plain_leaves13 = sk.LAUNCHES - s0
    s0 = sk.LAUNCHES
    pol13, pol13_ms = _wall_ms(lambda: solve_box_qp(*data0, config=cfg_pol))
    pol_leaves13 = sk.LAUNCHES - s0
    _check(plain_leaves13 % leaves10 == 0 and plain_leaves13 > 0
           and pol_leaves13 == plain_leaves13 + leaves10,
           f"polish: {pol_leaves13} leaf launches against {plain_leaves13} "
           f"unpolished (want {leaves10} more)")
    n_acc13 = int(pol13.polished.sum())
    res_pol = kkt_of(data0, pol13)
    res_plain = kkt_of(data0, plain13)
    # Per element, a polished residual may not exceed the unpolished one
    # beyond a floor: eps_abs (the polish's own acceptance margin) and, for
    # the equality, the float32 rounding of A x itself, sqrt(n) eps |A||x|
    # (both x satisfy A x = b only to that level at n=1000).
    with highest_matmul_precision():
        ax_scale = (data0.A.abs() @ pol13.x.abs()[..., None])[..., 0].amax(
            dim=-1)
    floors13 = {k: torch.full_like(v, cfg.eps_abs) for k, v in res_pol.items()}
    floors13["eq"] = torch.clamp(
        math.sqrt(N) * torch.finfo(torch.float32).eps * ax_scale,
        min=cfg.eps_abs)
    worse13 = {k: int((res_pol[k] > torch.maximum(res_plain[k],
                                                  floors13[k])).sum())
               for k in res_pol}
    better13 = {k: int((res_pol[k] <= res_plain[k]).sum()) for k in res_pol}
    _check(not any(worse13.values()), f"polish: kkt_residuals above the "
           f"unpolished ones (and their floors) for elements {worse13}: "
           + ", ".join(f"{k} {res_pol[k].max().item():.3e}/"
                       f"{res_plain[k].max().item():.3e}" for k in res_pol))
    dx13 = (pol13.x.double() - x64_5).abs().max().item()
    _check(dx13 <= 1e-3, f"polish: max|x - x_f64| = {dx13:.3e}")
    prep13 = prepare_box_qp(data0.Q, data0.A, data0.b, data0.lb, data0.ub,
                            config=cfg_pol)
    served13 = solve_box_qp_prepared(prep13, data0.p, config=cfg_pol)
    dprep13 = (served13.x - pol13.x).abs().max().item()
    _check(dprep13 <= 1e-6, f"polish: prepared vs direct {dprep13:.3e}")
    del prep13, served13
    print(f"phase 13 polish (B={B}, n={N}, f32, tol {TOL:g}): {n_acc13}/{B} "
          f"accepted; {pol_leaves13} leaf launches ({plain_leaves13} "
          f"unpolished + {leaves10}); kkt_residuals max polished/unpolished "
          + ", ".join(f"{k} {res_pol[k].max().item():.3e}/"
                      f"{res_plain[k].max().item():.3e} (no worse in "
                      f"{better13[k]}/{B})" for k in res_pol)
          + f", none above max(unpolished, floor) (eq floor "
          f"{floors13['eq'].max().item():.3e}); max|x - x_f64| "
          f"{dx13:.3e} (<= 1e-3), unpolished {(plain13.x.double() - x64_5).abs().max().item():.3e}; "
          f"prepared vs direct {dprep13:.3e} (<= 1e-6); request ms "
          f"unpolished {plain13_ms:.2f}, polished {pol13_ms:.2f} (polish "
          f"share {(pol13_ms - plain13_ms) / pol13_ms:.3f})")
    cfg_chol = dataclasses.replace(cfg, kkt_solver="cholesky")
    s0 = sk.LAUNCHES
    chol13, chol13_ms = _wall_ms(lambda: solve_box_qp(*data0,
                                                      config=cfg_chol))
    chol_leaves13 = sk.LAUNCHES - s0
    _check(chol_leaves13 == 0, f"Cholesky mode launched {chol_leaves13} "
           f"leaves")
    n_conv13 = int(chol13.converged.sum())
    _check(n_conv13 == B and bool(torch.isfinite(chol13.x).all()),
           f"Cholesky mode: {n_conv13}/{B} converged")
    dxc13 = (chol13.x.double() - x64_5).abs().max().item()
    _check(dxc13 <= 1e-3, f"Cholesky mode: max|x - x_f64| = {dxc13:.3e}")
    print(f"phase 13 kkt_solver='cholesky': {n_conv13}/{B} converged in "
          f"{chol13.iterations} iterations (inverse mode "
          f"{plain13.iterations}); 0 leaf launches; max|x - x_f64| "
          f"{dxc13:.3e} (<= 1e-3); request {chol13_ms:.2f} ms (inverse "
          f"mode {plain13_ms:.2f})")
    ref["it13_chol"] = chol13.iterations
    del pol13, plain13, chol13, direct0

    # 14. Anderson acceleration (window 10) on the straggler batch,
    # lock-step, against phase 8's plain lock-step solve.
    cfg_aa = dataclasses.replace(cfg_lock, acceleration=AA_WINDOW)
    plain8 = sols8["lock-step"]
    plain8_ms = sorted(ms for ms, _ in runs8["lock-step"][1:])[1]
    runs14 = []
    for _ in range(2):
        s0 = sk.LAUNCHES
        aa14, ms = _wall_ms(lambda: solve_box_qp(*data8, config=cfg_aa))
        runs14.append((ms, sk.LAUNCHES - s0))
    aa_leaves14 = runs14[0][1]
    n_conv14 = int(aa14.converged.sum())
    _check(n_conv14 == B and not bool(aa14.primal_infeasible.any())
           and bool(torch.isfinite(aa14.x).all()),
           f"Anderson: {n_conv14}/{B} converged, "
           f"{int(aa14.primal_infeasible.sum())} infeasible")
    _check(aa_leaves14 > 0 and aa_leaves14 % leaves10 == 0,
           f"Anderson: {aa_leaves14} leaf launches")
    dx14 = (aa14.x - plain8.x).abs().max().item()
    _check(dx14 <= 1e-2, f"Anderson vs plain: max|dx| = {dx14:.3e}")
    res_aa = kkt_of(data8, aa14)
    res_pl8 = kkt_of(data8, plain8)
    _check(all(res_aa[k].max() <= 10 * res_pl8[k].max() for k in res_aa),
           "Anderson: kkt_residuals above 10x the plain solve's: " + ", ".join(
               f"{k} {res_aa[k].max().item():.3e}/"
               f"{res_pl8[k].max().item():.3e}" for k in res_aa))
    Mg = torch.randn((B, AA_WINDOW, 2 * AA_WINDOW), device=dev)
    with highest_matmul_precision():
        Mg = Mg @ Mg.mT + torch.eye(AA_WINDOW, device=dev)
    lin._gj_inverse_small(Mg)
    gj_ms = _event_ms(lambda: lin._gj_inverse_small(Mg), 20)
    # Its ~70 small launches, enqueued behind a held stream: device time.
    gj_dev_ms = _event_ms(lambda: lin._gj_inverse_small(Mg), 20, True,
                          host_ms=3.0)
    print(f"phase 14 Anderson window {AA_WINDOW} on the straggler batch "
          f"(lock-step, B={B}, n={N}, f32, tol {TOL:g}): {n_conv14}/{B} "
          f"converged, none infeasible, in {aa14.iterations} iterations "
          f"(plain {plain8.iterations}); {aa_leaves14} leaf launches "
          f"({aa_leaves14 // leaves10 - 1} refactorizations); max|x - "
          f"x_plain| {dx14:.3e} (<= 1e-2); kkt_residuals max Anderson/plain "
          + ", ".join(f"{k} {res_aa[k].max().item():.3e}/"
                      f"{res_pl8[k].max().item():.3e}" for k in res_aa)
          + f" (<= 10x); request ms [{', '.join(f'{ms:.2f}' for ms, _ in runs14)}]"
          f" ({runs14[-1][0] / B:.4f} ms per problem, "
          f"{runs14[-1][0] / aa14.iterations:.3f} ms per iteration against "
          f"plain {plain8_ms / plain8.iterations:.3f}); one "
          f"_gj_inverse_small ({B},{AA_WINDOW},{AA_WINDOW}) {gj_ms:.4f} ms "
          f"at the host's pace, {gj_dev_ms:.4f} ms on the device")
    del aa14, data8, sols8, plain8, Mg

    # 15. The equality-constrained and unconstrained solvers on the serving
    # problems (create_qp_data seed 0), forward+backward with respect to Q
    # and p of sum(w x), held against the same calls in float64.
    data15 = create_qp_data(N, B, seed=0, dtype=torch.float32, device=dev)
    Q15, p15, A15, b15 = data15.Q, data15.p, data15.A, data15.b
    lines15 = []
    for name, fn, args in (("qp_eqcon", qp_eqcon, (A15, b15)),
                           ("qp_uncon", qp_uncon, ())):
        outs = {}
        for dt in (torch.float32, torch.float64):
            Qd = Q15.to(dt).requires_grad_(True)
            pd = p15.to(dt).requires_grad_(True)
            s0 = sk.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = fn(Qd, pd, *(a.to(dt) for a in args))
            gQ, gp = torch.autograd.grad((w10.to(dt) * x).sum(), (Qd, pd))
            torch.cuda.synchronize()
            outs[dt] = (x.detach(), gQ, gp, sk.LAUNCHES - s0,
                        (time.perf_counter() - t0) * 1e3)
        (x32, gQ32, gp32, lv, ms), (x64, gQ64, gp64, _, ms64) = (
            outs[torch.float32], outs[torch.float64])
        _check(lv == 0, f"{name}: {lv} leaf launches")
        if args:
            ref["x15"] = x32        # phase 27's OptNet tp without G
        rel = {k: ((a.double() - b_).abs().max() / b_.abs().max()).item()
               for k, a, b_ in (("x", x32, x64), ("dQ", gQ32, gQ64),
                                ("dp", gp32, gp64))}
        _check(all(v <= 1e-3 for v in rel.values()),
               f"{name} f32 vs f64: relative {rel}")
        sol = (solve_qp_eqcon(Q15, p15, A15, b15) if args
               else solve_qp_uncon(Q15, p15))
        with highest_matmul_precision():
            Qx = (Q15 @ sol.x[..., None])[..., 0]
            stat = Qx + p15
            if args:
                stat = stat + (A15.mT @ sol.nus[..., None])[..., 0]
                eq = ((A15 @ sol.x[..., None])[..., 0] - b15).abs().max()
                eq_rel = (eq / torch.clamp(b15.abs().max(), min=1.0)).item()
            else:
                eq_rel = 0.0
        stat_rel = (stat.abs().max() / torch.maximum(
            p15.abs().max(), Qx.abs().max())).item()
        _check(stat_rel <= 1e-3 and eq_rel <= 1e-3,
               f"{name}: relative stationarity {stat_rel:.3e}, equality "
               f"{eq_rel:.3e}")
        lines15.append(
            f"{name}: 0 leaf launches; f32 vs f64 relative max|dx| "
            f"{rel['x']:.3e}, |ddQ| {rel['dQ']:.3e}, |ddp| {rel['dp']:.3e} "
            f"(<= 1e-3); |Qx + p" + (" + A^T nu" if args else "")
            + f"|max / scale {stat_rel:.3e}" + (f", |Ax - b|max / scale "
                                               f"{eq_rel:.3e}" if args else "")
            + f" (<= 1e-3); forward+backward {ms:.2f} ms (f64 {ms64:.2f})")
    print(f"phase 15 equality-constrained and unconstrained solvers (B={B}, "
          f"n={N}): " + "; ".join(lines15))
    del data15, Q15, p15, A15, b15

    # 16-18: Experiment 1's interior-point columns
    # (experiments/experiment_1.py:230-256: OptNetConfig(tol, max_iters=30,
    # symmetrize=False), gradients with respect to Q and p).
    cfg_ip = OptNetConfig(tol=TOL, max_iters=30, symmetrize=False)
    leaves_n = N_PAD // LEAF

    def rel_max(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max()).item()

    def ip_fwd_bwd(layer, Q, p, *rest):
        """x, dQ, dp of sum(w10 * layer(Q, p, ...)), wall ms and the peak
        memory above what was allocated before."""
        Qg, pg = Q.clone().requires_grad_(True), p.clone().requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = layer(Qg, pg, *rest, config=cfg_ip)
        gQ, gp = torch.autograd.grad((w10 * x).sum(), (Qg, pg))
        torch.cuda.synchronize()
        return (x.detach(), gQ, gp, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() - base_mem)

    # 16. Box IP on phase 5's requests; the last iteration's diagonal is
    # kept to rebuild its factored operator.
    last_diag = []
    factor_fn = bip._factor

    def spy_factor(ops, Q, A, diag, int_reg):
        last_diag[:] = [diag]
        return factor_fn(ops, Q, A, diag, int_reg)

    bip._factor = spy_factor
    try:
        sk.LAUNCHES = 0
        (bip16, ms16), rounds16 = _polish_rounds(
            bip, "box_penalty_polish",
            lambda: _wall_ms(lambda: solve_box_qp_ip(*data0, config=cfg_ip)))
        launches16 = sk.LAUNCHES
    finally:
        bip._factor = factor_fn
    it16, conv16 = bip16.iterations, int(bip16.converged.sum())
    # Init, iterations, polish rounds.
    want16 = leaves_n * (1 + it16 + rounds16)
    _check(launches16 == want16 and rounds16 in (2, 3),
           f"box IP: {launches16} leaf launches, expected {want16} for "
           f"{it16} iterations and {rounds16} polish rounds")
    _check(bool(torch.isfinite(bip16.x).all()), "box IP: x not finite")
    # Every element within 1e-3 of float64; the count whose polish was
    # rejected (x bitwise the unpolished solve's) is printed.
    raw16 = solve_box_qp_ip(*data0, config=dataclasses.replace(
        cfg_ip, polish=False)).x
    kept16 = (bip16.x == raw16).all(dim=-1)
    dev16 = (bip16.x.double() - x64_5).abs().amax(dim=-1)
    dx16 = dev16.max().item()
    _check(dx16 <= 1e-3, f"box IP: max|x - x_f64| = {dx16:.3e}, "
           f"{int((dev16 > 1e-3).sum())} elements beyond 1e-3, "
           f"{int(kept16.sum())} polishes rejected")
    ms16w = [_wall_ms(lambda: solve_box_qp_ip(*data0, config=cfg_ip))[1]
             for _ in range(3)]
    # Where a request's time goes: 1 + iterations + polish rounds
    # factorizations of H = Q + diag(d) + int_reg I with their Schur pieces.
    with highest_matmul_precision():
        fact16_ms = _event_ms(lambda: bip._factor(
            DENSE, data0.Q, data0.A, last_diag[0], cfg_ip.int_reg), 3)
    share16 = (1 + it16 + rounds16) * fact16_ms / min(ms16w)
    x16, gQ16, gp16, fb16_ms, peak16 = ip_fwd_bwd(boxqp_ip, *data0)
    dlayer16 = (x16 - bip16.x).abs().max().item()
    _check(dlayer16 <= 1e-6, f"box IP: layer x vs solve x {dlayer16:.3e}")
    res16 = (bip16.x, bip16.lams, bip16.nus, data0.Q, data0.A, data0.lb,
             data0.ub)
    g32 = grads.box_qp_grad_kkt(w10, *res16)
    g64 = grads.box_qp_grad_kkt(w10.double(), *(t.double() for t in res16))
    wire16 = max(rel_max(gQ16, g32[0]), rel_max(gp16, g32[1]))
    rel16 = {"dQ": rel_max(g32[0], g64[0]), "dp": rel_max(g32[1], g64[1])}
    del g32, g64, gQ16, gp16
    _check(wire16 <= 1e-5, f"box IP: layer vs direct backward {wire16:.3e}")
    _check(all(v <= 1e-4 for v in rel16.values()),
           f"box IP: f32 vs f64 backward, relative {rel16}")
    # The leaf on the interior-point operator: the last iteration's
    # H = Q + diag(d_lo + d_hi) + int_reg I, inverted by spd_inverse_fast
    # with the kernel and with the plain leaf, against float64.
    H16 = data0.Q.clone()
    H16.diagonal(dim1=-2, dim2=-1).add_(last_diag[0] + cfg_ip.int_reg)
    dH = H16.diagonal(dim1=-2, dim2=-1)
    Hs16, deq = lin._equilibrate(H16)
    ds16 = Hs16.diagonal(dim1=-2, dim2=-1)
    off16 = (Hs16 - torch.diag_embed(ds16)).abs().max().item()
    with highest_matmul_precision():
        Hk16 = lin.spd_inverse_fast(H16)
        m0 = mk.LAUNCHES
        Hp16 = lin._schur_inverse(lin._pad_to_leaf(Hs16),
                                  leaf=sk.sweep_spd_inverse_ref,
                                  mirror=mk.mirror_block_ref)[:, :N, :N]
        _check(mk.LAUNCHES == m0, "the plain recursion launched the mirror")
        Hp16 = Hp16 * deq[..., :, None] * deq[..., None, :]
    inv16 = torch.cholesky_inverse(torch.linalg.cholesky(H16.double()))
    err16_k = (Hk16.double() - inv16).abs().max().item()
    err16_p = (Hp16.double() - inv16).abs().max().item()
    dd = deq.double()
    # The same errors on the equilibrated operator's inverse (every entry
    # on one scale).
    eq16_k = ((Hk16.double() - inv16) / dd[..., :, None]
              / dd[..., None, :]).abs().max().item()
    eq16_p = ((Hp16.double() - inv16) / dd[..., :, None]
              / dd[..., None, :]).abs().max().item()
    del H16, Hs16, Hk16, Hp16, inv16, dd
    _check(err16_k <= 2 * err16_p, f"leaf on the box-IP operator: kernel "
           f"error {err16_k:.3e} against plain {err16_p:.3e}")
    print(f"phase 16 box IP (Experiment 1's BoxIP, B={B}, n={N}, f32, tol "
          f"{TOL:g}, max_iters 30, polish): {conv16}/{B} converged in "
          f"{it16} iterations; {launches16} leaf launches (= {leaves_n} x "
          f"(1 init + {it16} iterations + {rounds16} polish rounds)); "
          f"max|x - x_f64| "
          f"{dx16:.3e} (<= 1e-3), {int(kept16.sum())} kept the "
          f"interior-point x (polish rejected); request ms "
          f"first {ms16:.2f}, warm "
          f"[{', '.join(f'{v:.2f}' for v in ms16w)}], one factorization "
          f"{fact16_ms:.2f} ms, x {1 + it16 + rounds16} = {share16:.3f} of the "
          f"fastest warm request; forward+backward "
          f"(d/dQ, d/dp of sum(w x)) {fb16_ms:.2f} ms, peak memory above "
          f"the inputs {peak16 / 2**30:.3f} GiB; layer vs direct backward "
          f"{wire16:.3e} (<= 1e-5); f32 vs f64 backward relative max|ddQ| "
          f"{rel16['dQ']:.3e}, max|ddp| {rel16['dp']:.3e} (<= 1e-4); last "
          f"iteration's H: diagonal [{dH.min().item():.3e}, "
          f"{dH.max().item():.3e}], after equilibration "
          f"[{ds16.min().item():.6f}, {ds16.max().item():.6f}] with "
          f"max|offdiag| {off16:.3e}; |Hinv - inv_f64|max kernel "
          f"{err16_k:.3e}, plain leaf {err16_p:.3e} (ratio "
          f"{err16_k / err16_p:.3f} <= 2); equilibrated kernel {eq16_k:.3e}, "
          f"plain {eq16_p:.3e}")
    del bip16, raw16, x16, dH, ds16, deq, last_diag

    # 17. OptNet IP on the same requests, the box as G = [-I; I] (the
    # condensed factorization: ni = 2n > n).
    G17, h17 = data0.with_G_h()
    args17 = (data0.Q, data0.p, data0.A, data0.b, G17, h17)
    _check(onet._use_condensed(cfg_ip, N, 2 * N), "OptNet: 'auto' did not "
           "pick the condensed factorization for ni = 2n")
    sk.LAUNCHES = 0
    # ``_solve_ip``: the solve and the multipliers the layer's backward
    # takes (the accepted polish's).
    (full17, ms17), rounds17 = _polish_rounds(
        onet, "gen_penalty_polish",
        lambda: _wall_ms(lambda: onet._solve_ip(*args17, cfg_ip)))
    on17, lams17 = full17[0], full17[2]
    launches17 = sk.LAUNCHES
    it17, conv17 = on17.iterations, int(on17.converged.sum())
    want17 = leaves_n * (1 + it17 + rounds17)
    _check(launches17 == want17 and rounds17 in (2, 3),
           f"OptNet condensed: {launches17} leaf launches, expected "
           f"{want17} for {it17} iterations and {rounds17} polish rounds")
    _check(bool(torch.isfinite(on17.x).all()), "OptNet: x not finite")
    dev17 = (on17.x.double() - x64_5).abs().amax(dim=-1)
    dx17 = dev17.max().item()
    kept17 = (on17.x == solve_qp_optnet(*args17, config=dataclasses.replace(
        cfg_ip, polish=False)).x).all(dim=-1)
    _check(dx17 <= 1e-3, f"OptNet: max|x - x_f64| = {dx17:.3e}, "
           f"{int(kept17.sum())} polishes rejected")
    ms17w = [_wall_ms(lambda: solve_qp_optnet(*args17, config=cfg_ip))[1]
             for _ in range(3)]
    kkt17 = kkt_residuals(*data0, on17.x, on17.lams, on17.nus)
    d17 = torch.ones((B, 2 * N), device=dev)
    with highest_matmul_precision():
        prod17_ms = _event_ms(lambda: data0.Q + G17.mT @ (
            d17[..., :, None] * G17), 3)
        fact17_ms = _event_ms(lambda: onet.ip_factor_condensed(
            data0.Q, data0.A, G17, d17, cfg_ip.int_reg), 3)
    del d17
    nfact17 = 1 + it17 + rounds17
    x17, gQ17, gp17, fb17_ms, peak17 = ip_fwd_bwd(qp_optnet, *args17)
    dlayer17 = (x17 - on17.x).abs().max().item()
    _check(dlayer17 <= 1e-6, f"OptNet: layer x vs solve x {dlayer17:.3e}")
    res17 = (on17.x, lams17, on17.slacks, on17.nus)
    g32 = onet.optnet_grads(w10, *res17, data0.Q, data0.A, G17, None,
                            cfg_ip.int_reg, want_dG=False)
    d64 = type(data0)(*(t.double() for t in data0))
    g64 = onet.optnet_grads(w10.double(), *(t.double() for t in res17),
                            d64.Q, d64.A, d64.with_G_h()[0], None,
                            cfg_ip.int_reg, want_dG=False)
    wire17 = max(rel_max(gQ17, g32[0]), rel_max(gp17, g32[1]))
    rel17 = {"dQ": rel_max(g32[0], g64[0]), "dp": rel_max(g32[1], g64[1])}
    del g32, g64, d64, gQ17, gp17
    _check(wire17 <= 1e-5, f"OptNet: layer vs direct backward {wire17:.3e}")
    _check(all(v <= 1e-4 for v in rel17.values()),
           f"OptNet: f32 vs f64 backward, relative {rel17}")
    print(f"phase 17 OptNet IP, condensed (Experiment 1's OptNet_IP, G = "
          f"[-I; I] ({B},{2 * N},{N}), f32, tol {TOL:g}, max_iters 30, "
          f"polish): 'auto' picks condensed; {conv17}/{B} converged in "
          f"{it17} iterations; {launches17} leaf launches (= {leaves_n} x "
          f"(1 + {it17} + {rounds17} polish rounds)); max|x - x_f64| "
          f"{dx17:.3e} (<= 1e-3), "
          f"{int(kept17.sum())} kept the interior-point x (polish "
          f"rejected); "
          f"kkt_residuals max " + ", ".join(
              f"{k} {v.max().item():.3e}" for k, v in kkt17.items())
          + f"; request ms first {ms17:.2f}, warm "
          f"[{', '.join(f'{v:.2f}' for v in ms17w)}], one condensed "
          f"factorization {fact17_ms:.2f} ms of which Q + G'(d G) "
          f"{prod17_ms:.2f} ms, x {nfact17} = "
          f"{nfact17 * fact17_ms / min(ms17w):.3f} of the fastest warm "
          f"request (the product {nfact17 * prod17_ms / min(ms17w):.3f}); "
          f"forward+backward "
          f"(G, h without grad) {fb17_ms:.2f} ms, peak memory above the "
          f"inputs {peak17 / 2**30:.3f} GiB (a dG would be "
          f"{4 * B * 2 * N * N / 2**30:.3f} GiB); layer vs direct backward "
          f"{wire17:.3e} (<= 1e-5); f32 vs f64 backward relative max|ddQ| "
          f"{rel17['dQ']:.3e}, max|ddp| {rel17['dp']:.3e} (<= 1e-4)")
    del on17, lams17, full17, x17, G17, h17, args17

    # 18. OptNet IP on general inequalities (ni < n: the Schur
    # factorization), random around a strictly feasible point as
    # tests/test_optnet.py:48-78 builds them.
    args18 = _general_ineq_data(N, B, N_INEQ, dev)
    Q18, p18, A18, b18, G18, h18 = args18
    _check(not onet._use_condensed(cfg_ip, N, N_INEQ), "OptNet: 'auto' did "
           "not pick the Schur factorization for ni < n")
    sk.LAUNCHES = 0
    (on18, ms18), rounds18 = _polish_rounds(
        onet, "gen_penalty_polish",
        lambda: _wall_ms(lambda: solve_qp_optnet(*args18, config=cfg_ip)))
    launches18 = sk.LAUNCHES
    it18, conv18 = on18.iterations, int(on18.converged.sum())
    # Q^-1 once, the ni x ni block at init and per iteration (S11 is 1 x 1:
    # no leaf), the n x n polish operator per round.
    leaves_ni = -(-N_INEQ // LEAF)
    want18 = leaves_n + leaves_ni * (1 + it18) + rounds18 * leaves_n
    _check(launches18 == want18 and rounds18 in (2, 3),
           f"OptNet Schur: {launches18} leaf launches, expected {want18} "
           f"for {it18} iterations and {rounds18} polish rounds")
    ms18w = [_wall_ms(lambda: solve_qp_optnet(*args18, config=cfg_ip))[1]
             for _ in range(3)]
    with highest_matmul_precision():
        pre18_ms = _event_ms(lambda: onet.ip_pre_factor(Q18, A18, G18), 3)
        f18 = onet.ip_pre_factor(Q18, A18, G18)
        d18 = torch.ones((B, N_INEQ), device=dev)
        l22_ms = _event_ms(lambda: onet.ip_factor_L22(f18, d18,
                                                      cfg_ip.int_reg), 3)
    del f18, d18
    with highest_matmul_precision():
        x18, lam18, s18 = on18.x, on18.lams, on18.slacks
        Qx = (Q18 @ x18[..., None])[..., 0]
        Gl = (G18.mT @ lam18[..., None])[..., 0]
        An = (A18.mT @ on18.nus[..., None])[..., 0]
        Ax = (A18 @ x18[..., None])[..., 0]
        Gx = (G18 @ x18[..., None])[..., 0]
    scale_in = torch.maximum(Gx.abs().amax(dim=-1), h18.abs().amax(dim=-1))
    kkt18 = {
        "stationarity": ((Qx + p18 + Gl + An).abs().amax(dim=-1) / torch.stack(
            [v.abs().amax(dim=-1) for v in (Qx, p18, Gl, An)]).amax(dim=0)),
        "equality": ((Ax - b18).abs().amax(dim=-1) / torch.maximum(
            Ax.abs().amax(dim=-1), b18.abs().amax(dim=-1))),
        "inequality": torch.clamp(Gx - h18, min=0.0).amax(dim=-1) / scale_in,
        "complementarity": ((lam18 * s18).amax(dim=-1)
                            / (lam18.amax(dim=-1) * scale_in))}
    kkt18 = {k: v.max().item() for k, v in kkt18.items()}
    _check(all(v <= 1e-3 for v in kkt18.values()),
           f"OptNet Schur: relative KKT residuals {kkt18}")
    # The condensed factorization of the same data, in float64: in float32
    # Q + G' diag(d) G of general rows outgrows float32 once d ~ 1e3 (the
    # JAX package returns NaN there; ROADMAP Queue 3).
    c18, ms18c = _wall_ms(lambda: solve_qp_optnet(
        *(t.double() for t in args18),
        config=dataclasses.replace(cfg_ip, factor="condensed")))
    _check(bool(c18.converged.all()), f"OptNet condensed float64: "
           f"{int(c18.converged.sum())}/{B} converged")
    dx18 = (x18.double() - c18.x).abs().max().item()
    _check(dx18 <= 1e-3, f"OptNet Schur f32 vs condensed f64: max|dx| "
           f"{dx18:.3e}")
    print(f"phase 18 OptNet IP, Schur (B={B}, n={N}, ni={N_INEQ}, m=1, "
          f"f32, tol {TOL:g}, max_iters 30, polish): 'auto' picks Schur; "
          f"{conv18}/{B} converged in {it18} iterations; {launches18} leaf "
          f"launches (= {leaves_n} Q^-1 + {leaves_ni} x (1 + {it18}) + "
          f"{rounds18} x {leaves_n} polish); relative KKT residuals max "
          + ", ".join(
              f"{k} {v:.3e}" for k, v in kkt18.items()) + " (<= 1e-3); "
          f"request ms first {ms18:.2f}, warm "
          f"[{', '.join(f'{v:.2f}' for v in ms18w)}], pre-factorization "
          f"(Q^-1 and the Schur blocks) {pre18_ms:.2f} ms, one "
          f"{N_INEQ}x{N_INEQ} refactorization {l22_ms:.2f} ms, x {1 + it18} "
          f"= {(1 + it18) * l22_ms / min(ms18w):.3f} of the fastest warm "
          f"request; condensed float64 "
          f"{c18.iterations} iterations, {ms18c:.2f} ms, max|x_schur_f32 - "
          f"x_condensed_f64| {dx18:.3e} (<= 1e-3)")
    ref.update(x64_18=c18.x.cpu(), it18=it18,
               q18_sum=float(Q18.double().sum()))
    del args18, Q18, p18, A18, b18, G18, h18, on18, c18

    # 19. Experiment 1's GenQP column (experiments/experiment_1.py:219-228):
    # phase 5's requests with the box as G = [-I; I], (B, 2n, n), and
    # GenQPConfig(tol, symmetrize=False); the prepared serving rollout of
    # experiments/experiment_serving.py:113-143; the layer's forward+backward
    # ('kkt'); one polished and one Anderson solve.  Every factorization is
    # counted (it launches one leaf per 128 rows).
    G19, h19 = data0.with_G_h()
    args19 = (data0.Q, data0.p, data0.A, data0.b, G19, h19)
    cfg19 = GenQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False)
    facts19 = []
    fact_fn = DENSE.factorize       # the solver factors through its operator

    def counted_fact(*a, **kw):
        facts19.append(1)
        return fact_fn(*a, **kw)

    def counted_run(fn):
        """fn()'s result, wall ms, leaf launches and factorizations."""
        facts19.clear()
        s0 = sk.LAUNCHES
        out, ms = _wall_ms(fn)
        return out, ms, sk.LAUNCHES - s0, len(facts19)

    def x_dev(sol):
        return (sol.x.double() - x64_5).abs().amax(dim=-1)

    def solve19(cfg):
        return solve_qp_gen(*args19, config=cfg)

    DENSE.factorize = counted_fact
    try:
        sk.LAUNCHES = 0
        sol19, ms19, leaves19, nf19 = counted_run(lambda: solve19(cfg19))
        prep19, prep19_ms, prep_leaves19, _ = counted_run(
            lambda: prepare_qp_gen(*args19[:1], *args19[2:], config=cfg19))
        gp19 = np.random.default_rng(19)
        p19, prev, served19 = data0.p, None, []
        for k in range(4):
            if k:
                noise = torch.as_tensor(gp19.standard_normal(tuple(p19.shape)),
                                        dtype=p19.dtype, device=dev)
                p19 = p19 + 0.01 * p19.abs().mean() * noise
            sol, ms, lv, nf = counted_run(lambda: solve_qp_gen_prepared(
                prep19, p19, config=cfg19, warm_start=prev))
            _check(bool(sol.converged.all())
                   and bool(torch.isfinite(sol.x).all()),
                   f"genqp prepared request {k}: "
                   f"{int(sol.converged.sum())}/{B} converged")
            _check(lv == leaves_n * nf, f"genqp prepared request {k}: {lv} "
                   f"leaf launches for {nf} refactorizations")
            if k == 0:
                dprep19 = (sol.x - sol19.x).abs().max().item()
            served19.append((sol.iterations, ms, nf))
            prev = sol
        launches19 = sk.LAUNCHES
        pol19, pol19_ms, pol_leaves19, pol_nf19 = counted_run(
            lambda: solve19(dataclasses.replace(cfg19, polish=True)))
        aa19, aa19_ms, aa_leaves19, aa_nf19 = counted_run(
            lambda: solve19(dataclasses.replace(cfg19,
                                                acceleration=AA_WINDOW)))
    finally:
        del DENSE.factorize                     # the class's method again
    conv19 = int(sol19.converged.sum())
    _check(conv19 == B and bool(torch.isfinite(sol19.x).all())
           and not bool(sol19.primal_infeasible.any()),
           f"genqp: {conv19}/{B} converged, "
           f"{int(sol19.primal_infeasible.sum())} infeasible")
    _check(nf19 >= 1 and leaves19 == leaves_n * nf19,
           f"genqp: {leaves19} leaf launches for {nf19} factorizations")
    _check(prep_leaves19 == leaves_n, f"prepare_qp_gen: {prep_leaves19} "
           f"leaf launches")
    _check(dprep19 <= 1e-6, f"genqp prepared vs direct {dprep19:.3e}")
    dev19 = x_dev(sol19)
    dx19 = dev19.max().item()
    _check(dx19 <= 1e-3, f"genqp: max|x - x_f64| = {dx19:.3e}, "
           f"{int((dev19 > 1e-3).sum())} elements beyond 1e-3")
    # The polish: one factorization more than the loop's; accepted where
    # the polished x replaced the iterate (the loop runs as unpolished).
    _check(pol19.iterations == sol19.iterations
           and pol_leaves19 == leaves_n * (pol_nf19 + 1),
           f"genqp polish: {pol_leaves19} leaf launches for {pol_nf19} "
           f"factorizations and the polish, {pol19.iterations} iterations")
    acc19 = int((pol19.x != sol19.x).any(dim=-1).sum())
    dx_pol19 = x_dev(pol19).max().item()
    _check(bool(pol19.converged.all()) and dx_pol19 <= 1e-3,
           f"genqp polish: max|x - x_f64| = {dx_pol19:.3e}")
    conv_aa19 = int(aa19.converged.sum())
    dx_aa19 = x_dev(aa19).max().item()
    _check(conv_aa19 == B and aa_leaves19 == leaves_n * aa_nf19
           and dx_aa19 <= 1e-3,
           f"genqp Anderson: {conv_aa19}/{B} converged, {aa_leaves19} leaf "
           f"launches for {aa_nf19} factorizations, max|x - x_f64| "
           f"{dx_aa19:.3e}")

    # The layer's forward+backward ('kkt'): gradients of sum(w x) with
    # respect to Q and p; G does not require grad, so dG is not built.
    want_dG19 = []
    kkt_fn = gq.gen_qp_grad_kkt

    def spy_kkt(*a, **kw):
        want_dG19.append(kw["want_dG"])
        return kkt_fn(*a, **kw)

    def gen_fwd_bwd(cfg):
        Qg = data0.Q.clone().requires_grad_(True)
        pg = data0.p.clone().requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        x = qp_gen(Qg, pg, *args19[2:], config=cfg)
        s0 = sk.LAUNCHES
        gQ, gp = torch.autograd.grad((w10 * x).sum(), (Qg, pg))
        bwd_leaves = sk.LAUNCHES - s0
        torch.cuda.synchronize()
        return (x.detach(), gQ, gp, bwd_leaves,
                torch.cuda.max_memory_allocated() - base_mem)

    gq.gen_qp_grad_kkt = spy_kkt
    try:
        x19, gQ19, gp19, bwd_leaves19, peak19 = gen_fwd_bwd(cfg19)
    finally:
        gq.gen_qp_grad_kkt = kkt_fn
    _check(want_dG19 == [False], f"genqp backward asked for dG: {want_dG19}")
    _check(bwd_leaves19 == leaves_n, f"genqp backward: {bwd_leaves19} leaf "
           f"launches, expected {leaves_n}")
    dlayer19 = (x19 - sol19.x).abs().max().item()
    _check(dlayer19 <= 1e-6, f"genqp: layer x vs solve x {dlayer19:.3e}")
    res19 = (sol19.x, sol19.lams, sol19.slacks, sol19.nus, data0.Q, data0.A,
             G19)
    g32 = gq.gen_qp_grad_kkt(w10, *res19, want_dG=False)
    g64 = gq.gen_qp_grad_kkt(w10.double(), *(t.double() for t in res19),
                             want_dG=False)
    wire19 = max(rel_max(gQ19, g32[0]), rel_max(gp19, g32[1]))
    rel19 = {"dQ": rel_max(g32[0], g64[0]), "dp": rel_max(g32[1], g64[1])}
    del g32, g64, gQ19, gp19
    _check(wire19 <= 1e-5, f"genqp: layer vs direct backward {wire19:.3e}")
    _check(all(v <= 1e-4 for v in rel19.values()),
           f"genqp: f32 vs f64 backward, relative {rel19}")

    # Times: each request and the forward+backward (utils.profiling.timed,
    # CUDA events), and the pieces of a request: the G'G product, one
    # factorization and one iteration's three GEMVs (G'v, Hinv r, G x).
    t_req19 = timed(lambda: solve19(cfg19), n=3)
    t_prep19 = timed(lambda: solve_qp_gen_prepared(prep19, data0.p,
                                                   config=cfg19), n=3)
    t_fb19 = timed(lambda: gen_fwd_bwd(cfg19), n=2)
    Gs19, rho19 = prep19.Gs, prep19.rho0
    vk = torch.ones((B, 2 * N), device=dev)
    with highest_matmul_precision():
        gtg19_ms = _event_ms(lambda: Gs19.mT @ Gs19, 3)
        fact19_ms = _event_ms(lambda: DENSE.factorize(gq._x_operator(
            prep19.Qs, prep19.GtG, rho19, cfg19.sigma), prep19.As), 3)
        gemv19_ms = _event_ms(lambda: gq._mv(Gs19, DENSE.kkt_apply(
            prep19.factors, gq._mv(Gs19.mT, vk), prep19.bs)[0]), 10)
    del vk, Gs19
    # One request under the profiler (utils.profiling.trace): its kernels'
    # summed device time (one stream: they do not overlap) over the median
    # unprofiled request is the device's busy share; the profiled wall
    # time carries the profiler's own cost.  The solver's spans appear on
    # the device's timeline too (user annotations): they are not kernels.
    with tempfile.TemporaryDirectory() as tmp19:
        with trace(tmp19) as prof19:
            _, traced19_ms = _wall_ms(lambda: solve19(cfg19))
        busy19_ms = sum(
            getattr(e, "self_device_time_total", 0) for e in
            prof19.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)) / 1e3
    it19 = sol19.iterations
    ref["it19"] = it19
    req19 = t_req19["median_s"] * 1e3
    print(f"phase 19 GenQP (Experiment 1's GenQP column, G = [-I; I] "
          f"({B},{2 * N},{N}), f32, tol {TOL:g}): {conv19}/{B} converged in "
          f"{it19} iterations, {nf19} factorizations ({nf19 - 1} "
          f"refactorizations), {leaves19} leaf launches (= {leaves_n} x "
          f"{nf19}); max|x - x_f64| {dx19:.3e} (<= 1e-3); request ms first "
          f"{ms19:.2f}, timed median {req19:.2f} (min "
          f"{t_req19['min_s'] * 1e3:.2f}, max {t_req19['max_s'] * 1e3:.2f}); "
          f"pieces: G'G {gtg19_ms:.2f} ms, one factorization "
          f"{fact19_ms:.2f} ms, one iteration's three GEMVs {gemv19_ms:.3f} "
          f"ms, so G'G + {nf19} factorizations + {it19} iterations = "
          f"{(gtg19_ms + nf19 * fact19_ms + it19 * gemv19_ms) / req19:.3f} "
          f"of the median request; one request under torch.profiler: "
          f"{traced19_ms:.2f} ms wall, its kernels {busy19_ms:.2f} ms, "
          f"{busy19_ms / req19:.3f} of the median request (the device's "
          f"busy share)")
    print(f"phase 19 GenQP serving (prepare once, 4 requests, p drifting 1% "
          f"per request, warm-started): prepare {prep19_ms:.2f} ms "
          f"({prep_leaves19} leaves); requests [" + "; ".join(
              f"{it} it {ms:.2f} ms {nf} refact." for it, ms, nf in served19)
          + f"] (cold {served19[0][0]} it, warm {[v[0] for v in served19[1:]]}"
          f"); first request vs direct {dprep19:.3e} (<= 1e-6); timed "
          f"prepared request median {t_prep19['median_s'] * 1e3:.2f} ms")
    print(f"phase 19 GenQP forward+backward (qp_gen, 'kkt', d/dQ and d/dp "
          f"of sum(w x)): {bwd_leaves19} leaf launches in the backward (= "
          f"{leaves_n}); dG not built (want_dG {want_dG19[0]}); layer vs "
          f"direct backward {wire19:.3e} (<= 1e-5); f32 vs f64 backward "
          f"relative max|ddQ| {rel19['dQ']:.3e}, max|ddp| {rel19['dp']:.3e} "
          f"(<= 1e-4); peak memory above the inputs {peak19 / 2**30:.3f} GiB "
          f"(a dG would be {4 * B * 2 * N * N / 2**30:.3f} GiB); timed "
          f"median {t_fb19['median_s'] * 1e3:.2f} ms (min "
          f"{t_fb19['min_s'] * 1e3:.2f})")
    print(f"phase 19 GenQP polish: {acc19}/{B} accepted, {pol19.iterations} "
          f"iterations, {pol_leaves19} leaf launches (= {leaves_n} x "
          f"({pol_nf19} + 1)), max|x - x_f64| {dx_pol19:.3e} (<= 1e-3; "
          f"unpolished {dx19:.3e}), {pol19_ms:.2f} ms; Anderson window "
          f"{AA_WINDOW}: {conv_aa19}/{B} converged in {aa19.iterations} "
          f"iterations ({aa_nf19} factorizations), max|x - x_f64| "
          f"{dx_aa19:.3e} (<= 1e-3), {aa19_ms:.2f} ms")
    del sol19, pol19, aa19, prep19, prev, x19, res19, args19, G19, h19
    del data0

    # 20. The conic backward on the card: phase 19's construction at
    # n=N_CONIC, where the dense self-dual system (B, N, N) with
    # N = n + 1 + 2n fits the 1 GiB budget.  Warnings are errors: a
    # fallback to 'kkt' fails the phase.
    data20 = create_qp_data(N_CONIC, B, seed=0, dtype=torch.float32,
                            device=dev)
    G20, h20 = data20.with_G_h()
    args20 = (data20.Q, data20.p, data20.A, data20.b, G20, h20)
    cfg20 = GenQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False,
                        backward="conic")
    need20 = conic_grad.conic_backward_bytes(B, N_CONIC, 1, 2 * N_CONIC, 4)
    _check(need20 <= conic_grad.CONIC_BACKWARD_MAX_BYTES,
           f"conic system {need20} bytes above the budget")
    w20 = torch.as_tensor(np.random.default_rng(20).standard_normal(
        (B, N_CONIC)), dtype=torch.float32, device=dev)
    solves20 = []
    solve_fn = torch.linalg.solve

    def spy_solve(Amat, rhs):
        solves20.append((Amat, rhs))
        return solve_fn(Amat, rhs)

    Q20 = data20.Q.clone().requires_grad_(True)
    p20 = data20.p.clone().requires_grad_(True)
    torch.linalg.solve = spy_solve
    ms20 = []
    try:
        # Twice: the first call includes the library's set-up.
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for _ in range(2):
                x20, fwd_ms = _wall_ms(lambda: qp_gen(Q20, p20, *args20[2:],
                                                      config=cfg20))
                (gQ20, gp20), bwd_ms = _wall_ms(lambda: torch.autograd.grad(
                    (w20 * x20).sum(), (Q20, p20)))
                ms20.append((fwd_ms, bwd_ms))
    finally:
        torch.linalg.solve = solve_fn
    _check(len(solves20) == 2, f"conic backward: {len(solves20)} solves "
           f"in two calls")
    sol20 = solve_qp_gen(*args20, config=cfg20)
    _check(bool(sol20.converged.all()), f"conic phase forward: "
           f"{int(sol20.converged.sum())}/{B} converged")
    res20 = (sol20.x, sol20.lams, sol20.slacks)
    c32 = conic_grad.conic_qp_grads(w20, *res20, data20.Q, data20.A, G20,
                                    want_dA=False, want_dG=False)
    c64 = conic_grad.conic_qp_grads(
        w20.double(), *(t.double() for t in res20), data20.Q.double(),
        data20.A.double(), G20.double(), want_dA=False, want_dG=False)
    k32 = gq.gen_qp_grad_kkt(w20, *res20, sol20.nus, data20.Q, data20.A,
                             G20, want_dA=False, want_dG=False)
    wire20 = max(rel_max(gQ20, c32[0]), rel_max(gp20, c32[1]))
    rel20 = {"dQ": rel_max(c32[0], c64[0]), "dp": rel_max(c32[1], c64[1])}
    vs_kkt20 = {"dQ": rel_max(c32[0], k32[0]), "dp": rel_max(c32[1], k32[1])}
    _check(wire20 <= 1e-5, f"conic: layer vs direct backward {wire20:.3e}")
    _check(all(v <= CONIC_F64_GATE for v in rel20.values()),
           f"conic: f32 vs f64 backward, relative {rel20}")
    _check(all(v <= CONIC_KKT_GATE for v in vs_kkt20.values()),
           f"conic vs kkt backward, relative {vs_kkt20}")
    mat20, rhs20 = solves20[0]
    with highest_matmul_precision():
        lu20_ms = _event_ms(lambda: solve_fn(mat20, rhs20), 3)
    N20 = N_CONIC + 1 + 2 * N_CONIC
    print(f"phase 20 conic backward (B={B}, n={N_CONIC}, G = [-I; I], f32, "
          f"tol {TOL:g}): the self-dual system ({B},{N20},{N20}) "
          f"{need20 / 2**30:.3f} GiB (budget "
          f"{conic_grad.CONIC_BACKWARD_MAX_BYTES / 2**30:.0f} GiB), no "
          f"fallback warning; {sol20.iterations} iterations forward, "
          f"{B}/{B} converged; layer vs direct backward {wire20:.3e} "
          f"(<= 1e-5); f32 vs f64 conic backward relative max|ddQ| "
          f"{rel20['dQ']:.3e}, max|ddp| {rel20['dp']:.3e} (<= "
          f"{CONIC_F64_GATE:g}); conic vs kkt at the same solution relative "
          f"max|ddQ| {vs_kkt20['dQ']:.3e}, max|ddp| {vs_kkt20['dp']:.3e} (<= "
          f"{CONIC_KKT_GATE:g}); forward/backward ms first "
          f"{ms20[0][0]:.2f}/{ms20[0][1]:.2f}, second "
          f"{ms20[1][0]:.2f}/{ms20[1][1]:.2f}; one torch.linalg.solve "
          f"{lu20_ms:.2f} ms")
    del data20, G20, h20, args20, x20, gQ20, gp20, c32, c64, k32, mat20
    del rhs20, solves20, sol20, res20

    # 21. Phase 11's trainer through checkpointed_run: ten steps
    # uninterrupted; five steps checkpointed under a temporary directory,
    # restored into a fresh state and resumed with the full index matrix.
    run21 = train.make_train_scan(BoxQPConfig(eps_abs=TOL, eps_rel=TOL),
                                  lr=LR2)
    sel21 = torch.as_tensor(sel11, device=dev)

    def state21(seed):
        return ckpt.init_train_state(train.init_params(
            N_FEAT2, N_X2, generator=torch.Generator(device=dev).manual_seed(
                seed), device=dev), STEPS2)

    s0 = sk.LAUNCHES
    full21, full21_ms = _wall_ms(lambda: ckpt.checkpointed_run(
        run21, state21(11), sel21, *full11))
    leaves21 = sk.LAUNCHES - s0
    with tempfile.TemporaryDirectory() as tmp21:
        ckpt.checkpointed_run(run21, state21(11), sel21[:STEPS2 // 2],
                              *full11, root=tmp21, every=STEPS2 // 2)
        latest21 = ckpt.latest_checkpoint(tmp21)
        _check(latest21 is not None
               and latest21.name == f"step_{STEPS2 // 2}",
               f"latest checkpoint {latest21}")
        resumed21 = ckpt.restore_train_state(latest21, state21(21))
        finished21 = ckpt.checkpointed_run(run21, resumed21, sel21, *full11)
    same21 = {"losses": torch.equal(finished21.losses, full21.losses),
              "W": torch.equal(finished21.params.W, full21.params.W),
              "bias": torch.equal(finished21.params.bias,
                                  full21.params.bias)}
    _check(all(same21.values()) and finished21.epoch == STEPS2,
           f"resumed trainer differs from the uninterrupted one: {same21}")
    _check(bool(torch.isfinite(full21.losses).all()),
           f"checkpointed trainer losses {full21.losses.tolist()}")
    same11 = full21.losses.tolist() == losses11
    print(f"phase 21 checkpointed trainer (phase 11's: n_x={N_X2}, "
          f"{STEPS2} steps): uninterrupted {full21_ms:.2f} ms, {leaves21} "
          f"leaf launches; {STEPS2 // 2} steps, checkpoint, restore into a "
          f"fresh state, resume with the full sel: losses, W and bias "
          f"bitwise the uninterrupted run's; losses "
          f"{'bitwise' if same11 else 'not bitwise'} phase 11's per-step "
          f"loop; loss per step "
          f"[{', '.join(f'{v:.5f}' for v in full21.losses.tolist())}]")

    # 22-23. The parallel layer, in worlds of worker processes on this card.
    ref.update(x5=x5, it5=it5, x64_5=x64_5)
    par = _parallel_phases(dev, ref)

    # 29. The port's experiment and demo drivers.
    drivers = _phase_29(dev)

    print(json.dumps({"kernels": [{
        "name": "sweep_spd_inverse", "route": "cuda",
        "source": "lqp_py_tpu_torch/csrc/sweep_spd_inverse.cu",
        "replaces": "lqp_py_tpu/ops/pallas/spd_inverse.py:53",
        "launches": launches, "launches_straggler": launches8_sweep,
        "launches_fwd_bwd": launches10, "launches_train": launches11,
        "launches_unrolled": launches12, "launches_polish": pol_leaves13,
        "launches_cholesky": chol_leaves13, "launches_anderson": aa_leaves14,
        "launches_box_ip": launches16, "launches_optnet": launches17,
        "launches_optnet_schur": launches18, "launches_genqp": launches19,
        "launches_genqp_bwd": bwd_leaves19,
        "launches_genqp_polish": pol_leaves19,
        "launches_dp": par["launches_dp"], "launches_tp": par["launches_tp"],
        "launches_tp_per_rank": par["launches_tp_per_rank"],
        "launches_tp_genqp_per_rank": par["launches_tp_genqp"],
        "launches_tp_box_ip_per_rank": par["launches_tp_box_ip"],
        "launches_tp_optnet_schur_per_rank": par["launches_tp_optnet_schur"],
        "launches_tp_optnet_condensed_per_rank":
            par["launches_tp_optnet_condensed"],
        "launches_tp_cholesky_per_rank": par["launches_tp_cholesky"],
        "launches_tp_optnet_eq_per_rank": par["launches_tp_optnet_eq"],
        "launches_train_sharded_per_rank": par["launches_train_sharded"],
        "launches_dryrun_per_rank": par["launches_dryrun"],
        "launches_drivers": {k: v[0] for k, v in drivers.items()},
        "err_ip_vs_f64": err16_k,
        "plain_err_ip_vs_f64": err16_p,
        "max_abs_err": max_abs, "ms": kernel_ms, "ms_paced": paced_ms,
        "plain_ms": plain_ms, "bound_ms": leaf_bound[0],
        "bound_by": leaf_bound[1], "library_ms": leaf_lib_ms,
        "regs": attrs["regs"], "local_bytes": attrs["local_bytes"]}, {
        "name": "gemv_early_exit", "route": "cuda",
        "source": "lqp_py_tpu_torch/csrc/gemv_early_exit.cu",
        "replaces": "lqp_py_tpu/ops/pallas/admm_step.py:52",
        "launches": launches8_gemv,
        "max_abs_err": max(v["err"] for v in gemv.values()),
        "launches_big_batch": launches_big, "max_abs_err_big_batch": errb,
        "launches_tp": par["launches_gemv_tp"],
        "launches_tp_per_rank": par["launches_gemv_tp_per_rank"],
        "launches_drivers": {k: v[1] for k, v in drivers.items() if v[1]},
        "ms_rect": rect[0.0]["ms"], "plain_ms_rect": rect[0.0]["plain_ms"],
        "library_ms_rect": rect[0.0]["library_ms"],
        "bound_ms_rect": rect[0.0]["bound"][0],
        "bound_by_rect": rect[0.0]["bound"][1],
        "max_abs_err_rect": max(v["err"] for v in rect.values()),
        "ms_rect_50": rect[0.5]["ms"], "ms_rect_90": rect[0.9]["ms"],
        "bound_ms_rect_90": rect[0.9]["bound"][0],
        "ms": gemv[0.0]["ms"], "plain_ms": gemv[0.0]["plain_ms"],
        "bound_ms": gemv_bound[0], "bound_by": gemv_bound[1],
        "library_ms": gemv_lib_ms, "ms_in_turns": gemv_turn_ms,
        "ms_50": gemv[0.5]["ms"], "plain_ms_50": gemv[0.5]["plain_ms"],
        "ms_90": gemv[0.9]["ms"], "plain_ms_90": gemv[0.9]["plain_ms"],
        "paced_ms": {f"{f:.0%}": gemv[f]["paced_ms"] for f in gemv},
        "paced_plain_ms": {f"{f:.0%}": gemv[f]["paced_plain_ms"]
                           for f in gemv},
        "gb_per_s_0": gbps0, "frozen_share_straggler": share8,
        "ratio_90_0": ratio90,
        "turns_vs_call": vs_call, "regs": attrs7["regs"],
        "local_bytes": attrs7["local_bytes"]}, {
        "name": "block_spd_inverse", "route": "cuda",
        "source": "lqp_py_tpu_torch/csrc/block_spd_inverse.cu",
        "replaces": "lqp_py_tpu/ops/pallas/block_inverse.py:99",
        "launches": launches9, "max_abs_err": max_abs9,
        "ms": ms9["kernel"], "plain_ms": ms9["plain"],
        "recursion_ms": ms9["recursion"], "turns_vs_recursion": vs_rec,
        "err_vs_f64": err9_k, "plain_err_vs_f64": err9_r,
        "bound_ms": block_bound[0], "bound_by": block_bound[1],
        "library_ms": ms9["cholesky_inverse"], "regs": attrs9["regs"],
        "local_bytes": attrs9["local_bytes"]}, {
        "name": "mirror_block", "route": "cuda",
        "source": "lqp_py_tpu_torch/csrc/mirror_block.cu",
        "replaces": "lqp_py_tpu/ops/linalg.py:174",
        "launches": mirrors6, "launches_factorization": mirror_calls,
        "launches_fwd_bwd": mirrors10, "launches_bwd": bwd_mirrors10,
        "max_abs_err": mirror_err, "batch": B_BENCH, "blocks": len(nodes),
        "ms": mirror_ms, "plain_ms": mirror_plain_ms,
        "bound_ms": mirror_bound[0], "bound_by": mirror_bound[1],
        "library_ms": mirror_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def _phase_29(dev):
    """Phase 29: the port's drivers (``lqp_py_tpu_torch.experiments`` and
    ``lqp_py_tpu_torch.demo``) on this card at their published width
    (``D29``), each through the pieces or the ``main`` a user calls, with
    the drivers' own gates; every artifact goes to a temporary directory,
    and the README renderer renders into a copy of README.  Returns
    ``{driver: (leaf launches, GEMV launches)}`` of each driver's run."""
    import contextlib
    import io
    import shutil

    from lqp_py_tpu_torch.cpu import native
    from lqp_py_tpu_torch.demo import (demo_box_qp_layer, demo_polish,
                                       demo_solve_box_qp,
                                       demo_solve_box_qp_numpy,
                                       demo_status_reporting)
    from lqp_py_tpu_torch.experiments import experiment_1 as e1
    from lqp_py_tpu_torch.experiments import (experiment_1_hard,
                                              experiment_1_paper,
                                              experiment_2, experiment_aa,
                                              experiment_ip_accuracy,
                                              experiment_scaling,
                                              experiment_serving,
                                              experiment_straggler,
                                              render_readme)
    from lqp_py_tpu_torch.ops.kernels import admm_step as gk
    from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
    from lqp_py_tpu_torch.utils.generators import create_qp_data

    d, dv = D29, ["--device", DEVICE]
    launches, walls = {}, {}
    t29 = time.perf_counter()

    def run(name, fn):
        """``fn()`` with the driver's own output captured (printed only
        if it fails); its leaf and GEMV launches and wall seconds."""
        buf = io.StringIO()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        sk.LAUNCHES, gk.LAUNCHES = 0, 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(buf):
                out = fn()
        except BaseException:
            print(buf.getvalue())
            raise
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        launches[name] = (sk.LAUNCHES, gk.LAUNCHES)
        walls[name] = time.perf_counter() - t0
        return out

    def art(name):
        return json.loads((Path(out) / name).read_text())

    _check(native.available() or DEVICE == "cpu",
           "the native C++ solver did not build from native/lqp_native.cpp "
           "(cpu/native.py, g++)")
    with tempfile.TemporaryDirectory() as out:
        # Experiment 1: every GPU column at n=exp1_n with its gates, the
        # native column at native_n; the artifact through e1.save.
        n1 = d["exp1_n"]
        r1 = run("exp1", lambda: e1.run_size(n1, B, TOL, 2, True, dev,
                                             include_native=False))
        data_n = create_qp_data(d["native_n"], B, seed=0,
                                dtype=torch.float32, device=dev)
        results1 = {n1: r1}
        if native.available():
            results1[d["native_n"]] = {"Native_CPU_fwd": run(
                "native", lambda: e1.native_column(data_n, TOL))}
        del data_n
        with contextlib.redirect_stdout(io.StringIO()):
            e1.save(out, results1, dev, B, TOL, 2)
        peak = r1["ADMM_Unroll"].get("peak_mem_bytes")
        print(f"phase 29 Experiment 1 (experiment_1.run_size, n={n1}, "
              f"B={B}, f32, tol {TOL:g}; cut: sizes {{{n1}}} of 10-1000, "
              f"n_sims 2 of 5, the native column at n={d['native_n']}): "
              + "; ".join(
                  f"{k} total {v['total'] * 1e3:.2f} ms (fwd "
                  f"{v['fwd'] * 1e3:.2f}, device_total "
                  f"{v['device_total'] * 1e3:.2f}), "
                  f"{v.get('n_converged', '-')}/{B} converged, "
                  f"{v.get('iterations', '-')} it, max|x - x_tight| "
                  f"{v['max_dev_x_vs_tight']:.2e}" for k, v in r1.items())
              + f" (all < DEV_GATE {e1.DEV_GATE:g}); the unrolled column's "
              f"peak {peak / 2**30 if peak else float('nan'):.2f} GiB; "
              + (f"native fwd at n={d['native_n']} "
                 f"{results1[d['native_n']]['Native_CPU_fwd']['fwd']:.2f} s; "
                 if d["native_n"] in results1 else "native unavailable; ")
              + f"{launches['exp1'][0]} leaf launches; "
              f"{walls['exp1']:.1f} s")

        # Experiment 2: both paths and their gate.
        run("exp2", lambda: experiment_2.main([
            "--n-x", str(N_X2), "--n-features", str(N_FEAT2), "--n-batch",
            str(N_BATCH2), "--mini-batch", str(MINI2), "--epochs",
            str(STEPS2), "--lr", str(LR2), *dv, "--out-dir", out]))
        a2 = art(experiment_2.ARTIFACT)
        print(f"phase 29 Experiment 2 (experiment_2.main, n_x={N_X2}, "
              f"{N_FEAT2} features, minibatch {MINI2} of {N_BATCH2}, lr "
              f"{LR2:g}; cut: {STEPS2} epochs of 100): per-step "
              f"{a2['total_time_s']:.3f} s, whole horizon "
              f"{a2['fused_total_s']:.3f} s (first run "
              f"{a2['fused_compile_s']:.3f}); loss {a2['losses'][0]:.5f} -> "
              f"{a2['losses'][-1]:.5f}, paths agree to "
              f"{a2['fused_vs_loop_loss_dev']:.2e}; "
              f"{launches['exp2'][0]} leaf launches; {walls['exp2']:.1f} s")

        run("serving", lambda: experiment_serving.main([
            "--n-x", str(d["serving_n"]), "--n-batch", str(B), "--steps",
            "5", *dv, "--out-dir", out]))
        a = art(experiment_serving.ARTIFACT)
        print(f"phase 29 serving (experiment_serving.main, n={a['n_x']}, "
              f"B={B}; cut: 5 steps of 20): cold median "
              f"{statistics.median(a['cold']) * 1e3:.2f} ms "
              f"({a['cold_iters']} it), warm "
              f"{statistics.median(a['warm']) * 1e3:.2f} ms "
              f"({a['warm_iters']} it), rollout "
              f"{a['fused_per_solve'] * 1e3:.2f} ms/solve, GenQP rollout "
              f"{a['genqp_fused_per_solve'] * 1e3:.2f} ms/solve; "
              f"{launches['serving'][0]} leaf launches; "
              f"{walls['serving']:.1f} s")

        run("straggler", lambda: experiment_straggler.main([
            "--n-x", str(d["straggler_n"]), "--n-batch", str(B), "--n-hard",
            str(N_HARD), "--n-reps", "2", *dv, "--out-dir", out]))
        a = art(experiment_straggler.ARTIFACT)["results"][
            str(d["straggler_n"])]
        print(f"phase 29 straggler (experiment_straggler.main, n="
              f"{a['n_x']}, {a['n_hard']} hard of {B}; cut: n_reps 2 of 7): "
              + "; ".join(f"{k} {a[k]['median_s'] * 1e3:.2f} ms, "
                          f"{a[k]['iterations']} it, {a[k]['n_converged']}/"
                          f"{B} converged" for k in ("xla_step",
                                                     "pallas_step"))
              + f"; max dx between paths {a['max_dx_between_paths']:.2e}; "
              f"{launches['straggler'][1]} GEMV launches, "
              f"{launches['straggler'][0]} leaf launches; "
              f"{walls['straggler']:.1f} s")
        _check(launches["straggler"][1] > 0,
               "the straggler driver's early-exit column launched no GEMV")

        run("exp1_paper", lambda: experiment_1_paper.main([
            "--n-x", str(d["paper_n"]), "--n-batch", str(B), "--n-sims",
            "1", *dv, "--out-dir", out]))
        a = art(experiment_1_paper.ARTIFACT)["results"]
        print(f"phase 29 Experiment 1 paper (experiment_1_paper.main, dz="
              f"{d['paper_n']}, tols 1e-1/1e-3/1e-5; cut: n_sims 1 of 10): "
              + ", ".join(f"{k} {v['total'] * 1e3:.1f}" for k, v in a.items())
              + f" ms; {launches['exp1_paper'][0]} leaf launches; "
              f"{walls['exp1_paper']:.1f} s")

        run("exp1_hard", lambda: experiment_1_hard.main([
            "--sizes", str(d["hard_n"]), "--n-batch", str(B), "--n-sims",
            "1", *dv, "--out-dir", out]))
        a = art(experiment_1_hard.ARTIFACT)["results"][str(d["hard_n"])]
        print(f"phase 29 Experiment 1 hard (experiment_1_hard.main, n="
              f"{d['hard_n']}; cut: sizes {{{d['hard_n']}}} of 50-500, "
              f"n_sims 1 of 5): " + ", ".join(
                  f"{k} {v * 1e3:.1f} ms" if isinstance(v, float)
                  else f"{k} {v}" for k, v in a.items())
              + f"; {launches['exp1_hard'][0]} leaf launches; "
              f"{walls['exp1_hard']:.1f} s")

        run("aa", lambda: experiment_aa.main([
            "--sizes", str(d["aa_n"]), "--n-batch", str(d["aa_batch"]),
            "--n-sims", "1", *dv, "--out-dir", out]))
        a = art(experiment_aa.ARTIFACT)["results"]
        print(f"phase 29 Anderson (experiment_aa.main, n={d['aa_n']}, B="
              f"{d['aa_batch']}, windows 10/20; cut: sizes {{{d['aa_n']}}} "
              f"of 50-250, n_sims 1 of 5): " + "; ".join(
                  f"{cell} " + ", ".join(
                      f"{k} {v['iters']} it {v['n_converged']} conv"
                      for k, v in rec.items()) for cell, rec in a.items())
              + f"; {launches['aa'][0]} leaf launches; {walls['aa']:.1f} s")

        run("ip_accuracy", lambda: experiment_ip_accuracy.main([
            "--sizes", str(d["ip_n"]), "--n-batch", str(B), "--n-reps", "1",
            "--n-oracle", "2", *dv, "--out-dir", out]))
        a = art(experiment_ip_accuracy.ARTIFACT)["cells"]
        print(f"phase 29 IP accuracy (experiment_ip_accuracy.main, n="
              f"{d['ip_n']}; cut: sizes {{{d['ip_n']}}} of 500/1000, n_reps "
              f"1 of 5, n_oracle 2 of 8): " + "; ".join(
                  f"{c['solver']} r{c['refine_steps']} "
                  f"{'pol' if c['polish'] else 'plain'} f64 "
                  f"{c['max_dev_x_vs_f64']:.1e} tight "
                  f"{c['max_dev_x_vs_tight']:.1e} {c['fwd_s'] * 1e3:.1f} ms"
                  for c in a)
              + f"; {launches['ip_accuracy'][0]} leaf launches; "
              f"{walls['ip_accuracy']:.1f} s")

        worlds = run("scaling", lambda: experiment_scaling.main([
            "--nproc", "2", "--backend", "gloo", "--n-x",
            str(d["scaling_n"]), "--per-dev-batch", str(d["scaling_batch"]),
            "--timeout", str(PAR_TIMEOUT_S), *dv]))
        print(f"phase 29 scaling (experiment_scaling.main, two gloo ranks "
              f"on the card, n={d['scaling_n']}, {d['scaling_batch']} a "
              f"rank): " + "; ".join(
                  f"world {w}: |dx| lock-step "
                  f"{max(r['err_sharded'] for r in ranks):.1e}, shard_map "
                  f"{max(r['err_shard_map'] for r in ranks):.1e}"
                  for w, ranks in worlds.items())
              + f"; tp=2 |dx| {max(r['err_tp'] for r in worlds[2]):.1e} "
              f"(all < {experiment_scaling.GATE:g}); "
              f"{walls['scaling']:.1f} s")

        err_native = run("demo_solve_box_qp", lambda: demo_solve_box_qp.main(
            ["--n-x", str(d["demo_n"]), "--n-batch", str(B), *dv]))
        diffs = run("demo_box_qp_layer", lambda: demo_box_qp_layer.main(
            ["--n-x", str(d["layer_n"]), "--n-batch",
             str(d["layer_batch"]), *dv]))
        rows = run("demo_polish", lambda: demo_polish.main(dv))
        run("demo_status_reporting", lambda: demo_status_reporting.main(dv))
        dx_np = run("demo_solve_box_qp_numpy",
                    lambda: demo_solve_box_qp_numpy.main(dv))
        print(f"phase 29 demos (published sizes, no cut): solve n="
              f"{d['demo_n']} B={B} vs native "
              + (f"{err_native:.2e} (<= {DEMO_NATIVE_TOL:g})"
                 if err_native is not None else "n/a")
              + f"; layer n={d['layer_n']} B={d['layer_batch']} kkt/unroll "
              f"vs fixed point max|ddp| {diffs['kkt'][1]:.2e}/"
              f"{diffs['unroll'][1]:.2e} (<= {DEMO_DP_TOL:g}); polish "
              f"loose+polish max|x - x*| {rows['loose + polish'][1]:.1e}; "
              f"status: infeasibility certified; numpy vs torch "
              f"{dx_np:.2e} (< 1e-5); " + ", ".join(
                  f"{k} {launches[k][0]} leaves {walls[k]:.1f} s"
                  for k in launches if k.startswith("demo")))
        # Native is None only where g++ is missing, which the phase's
        # first check allows on the CPU alone.
        _check(err_native is None or err_native <= DEMO_NATIVE_TOL,
               f"demo_solve_box_qp: max|x - x_native| {err_native:.2e} > "
               f"{DEMO_NATIVE_TOL:g}")
        for name, (_, ddp) in diffs.items():
            _check(ddp <= DEMO_DP_TOL, f"demo_box_qp_layer: {name} dp is "
                   f"{ddp:.2e} from the fixed-point dp (> {DEMO_DP_TOL:g})")

        readme = Path(out) / "README.md"
        shutil.copy(Path(__file__).resolve().parent / "README.md", readme)
        jax_block = readme.read_text().split(
            "<!-- BEGIN AUTOGEN NUMBERS")[1].split(
            "<!-- END AUTOGEN NUMBERS -->")[0]
        run("render_readme", lambda: render_readme.main(
            ["--readme", str(readme), "--artifacts-dir", out]))
        text = readme.read_text()
        block = text.split(render_readme.BEGIN)[1].split(
            render_readme.END)[0]
        _check("not captured" not in block,
               "the rendered port block lacks an artifact phase 29 wrote")
        _check(jax_block in text, "the renderer changed the JAX block")
        n_art = len(list(Path(out).glob("*_torch.json")))
        print(f"phase 29 README renderer (render_readme.main on a copy): "
              f"{len(block.splitlines())} lines from the {n_art} "
              f"artifacts, the JAX block unchanged")
    for name in ("exp1", "exp2", "serving", "straggler", "exp1_paper",
                 "exp1_hard", "aa", "ip_accuracy", "demo_solve_box_qp",
                 "demo_box_qp_layer"):
        _check(launches[name][0] > 0, f"phase 29: {name} launched no leaf")
    print(f"phase 29 drivers: {time.perf_counter() - t29:.1f} s in all")
    return launches


def _parallel_phases(dev, ref):
    """Phases 22-26: ``lqp_py_tpu_torch.parallel`` on the requests of the
    earlier phases, held to their answers (``ref``).

    A world of two ranks on this one card with ``backend="gloo"`` (NCCL
    refuses two ranks on one device; gloo stages CUDA tensors through the
    host, so its times measure that, not NVLink) runs the lock-step dp
    solve, the shard_map variant, ``boxqp_sharded``'s d/dp and the tp=2
    solve (on the whole problem, then on the rank's blocks with the whole
    problem on the host) with its memory; a one-rank world on the default
    card backend (NCCL) runs the dp solve and the tp=1 solve the memory
    gate compares with.  The ranks are this script with ``--worker``
    (``_parallel_worker``), started by ``parallel/launch.py``; a failed
    rank fails the phase.  The gloo world also runs the tp=2 solves of
    phases 24-26 (GenQP, the box IP, OptNet in both modes, the box ADMM
    with polish, Anderson and the early-exit step) and phase 27 (the box
    ADMM in Cholesky mode, OptNet without G); the one-rank world the tp=1
    GenQP and Cholesky solves the memory gates of phases 24 and 27 compare
    with.  Phase 28 is a world of four gloo ranks, a (2, 2) mesh: the
    sharded trainer and the dry run."""
    from lqp_py_tpu_torch import BoxQPConfig, boxqp
    from lqp_py_tpu_torch.parallel import tp as tpm
    from lqp_py_tpu_torch.parallel.launch import launch
    from lqp_py_tpu_torch.utils.generators import create_qp_data

    x5, it5, x64_5 = ref["x5"], ref["it5"], ref["x64_5"]
    cfg = BoxQPConfig(eps_abs=TOL, eps_rel=TOL, symmetrize=False)
    data = create_qp_data(N, B, seed=0, dtype=torch.float32, device=dev)
    w = torch.randn((B, N), generator=torch.Generator(device=dev).manual_seed(
        W_SEED), device=dev)
    p1 = data.p.clone().requires_grad_()
    x1 = boxqp(data.Q, p1, data.A, data.b, data.lb, data.ub, config=cfg)
    g1 = torch.autograd.grad((w * x1).sum(), p1)[0]
    spec = {"device": DEVICE, "N": N, "B": B, "TOL": TOL,
            "q_sum": float(data.Q.double().sum()),
            "p_sum": float(data.p.double().sum()), "N_HARD": N_HARD,
            "N_INEQ": N_INEQ, "N_COND": N_COND, "AA_WINDOW": AA_WINDOW,
            "q8_sum": ref["q8_sum"], "q18_sum": ref["q18_sum"],
            "N_X2": N_X2, "N_BATCH2": N_BATCH2, "LR2": LR2,
            "q11_sum": ref["train11"]["q_sum"]}
    del data, x1, p1
    # Phase 25's condensed OptNet at n=N_COND: its float64 answer (the box
    # ADMM at tol 1e-9, as phase 5's).
    from lqp_py_tpu_torch import solve_box_qp
    dc = create_qp_data(N_COND, B, seed=0, dtype=torch.float32, device=dev)
    ref["x64_cond"] = solve_box_qp(*(t.double() for t in dc),
                                   config=BoxQPConfig(eps_abs=1e-9,
                                                      eps_rel=1e-9,
                                                      symmetrize=False)).x
    del dc
    t11 = ref["train11"]
    with tempfile.TemporaryDirectory() as tmp:
        spec["out"] = tmp
        with open(f"{tmp}/spec.json", "w") as f:
            json.dump(spec, f)
        np.savez(f"{tmp}/train11.npz", feats=t11["feats"].numpy(),
                 p_true=t11["p_true"].numpy(), sel=t11["sel"],
                 W0=t11["W0"].numpy())
        ranks = {}
        for world, nproc in (("gloo", 2), ("nccl", 1), ("train", 4)):
            t0 = time.perf_counter()
            launch([sys.executable, __file__, "--worker", f"{tmp}/spec.json",
                    world], nproc, timeout_s=PAR_TIMEOUT_S,
                   cwd=str(Path(__file__).resolve().parent))
            ranks[world] = [(json.loads(Path(f"{tmp}/{world}{r}.json")
                                        .read_text()),
                             dict(np.load(f"{tmp}/{world}{r}.npz")))
                            for r in range(nproc)]
            ranks[world + "_s"] = time.perf_counter() - t0
    gloo, nccl = ranks["gloo"], ranks["nccl"]

    def cat(key, world=gloo):
        return torch.from_numpy(np.concatenate([a[key] for _, a in world]))

    # 22. dp.
    for info, _ in gloo + nccl:
        _check(info["dp_it"] == it5, f"dp iterations {info['dp_it']} != "
               f"phase 5's {it5}")
        _check(info["dp_launches"] > 0, "the dp path launched no leaf")
    conv = cat("dp_converged")
    _check(bool(conv.all()), f"dp: {int(conv.sum())}/{B} converged")
    dx22 = (cat("dp_x").to(dev) - x5).abs().max().item()
    _check(dx22 <= 1e-5, f"dp: max|x - x_phase5| = {dx22:.3e}")
    dx22n = (cat("dp_x", nccl).to(dev) - x5).abs().max().item()
    _check(dx22n <= 1e-5, f"one-rank {nccl[0][0]['backend']}: max|x - "
           f"x_phase5| = {dx22n:.3e}")
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    _check(nccl[0][0]["backend"] == backend,
           f"the one-rank world runs {nccl[0][0]['backend']}, not {backend}")
    _check(bool(cat("sm_converged").all()), "shard_map: not all converged")
    dsm22 = (cat("sm_x").to(dev).double() - x64_5).abs().max().item()
    _check(dsm22 <= 1e-3, f"shard_map: max|x - x_f64| = {dsm22:.3e}")
    dg22 = ((cat("grad").to(dev) - g1).abs().max()
            / g1.abs().max()).item()
    _check(dg22 <= 1e-4, f"boxqp_sharded d/dp relative error {dg22:.3e}")
    dp_ms = [i["dp_ms"] for i, _ in gloo]
    print(f"phase 22 dp (lqp_py_tpu_torch.parallel, phase 5's B={B}, n={N}, "
          f"f32 requests): two ranks on one card, backend "
          f"{gloo[0][0]['backend']} (chosen; it stages through the host): "
          f"{B}/{B} converged in {gloo[0][0]['dp_it']} iterations (phase 5's "
          f"{it5}), max|x - x_phase5| {dx22:.3e} (<= 1e-5), "
          f"{[i['dp_collectives'] for i, _ in gloo]} flag all-reduces, "
          f"request {max(dp_ms):.2f} ms (ranks "
          f"{[round(v, 2) for v in dp_ms]}), leaf launches "
          f"{[i['dp_launches'] for i, _ in gloo]}; shard_map iterations per "
          f"rank {[int(a['sm_it'][0]) for _, a in gloo]}, max|x - x_f64| "
          f"{dsm22:.3e} (<= 1e-3); boxqp_sharded d/dp vs the one-process "
          f"layer {dg22:.3e} relative (<= 1e-4); one-rank world on "
          f"{nccl[0][0]['backend']} (the card's default): "
          f"{nccl[0][0]['dp_it']} iterations, max|x - x_phase5| "
          f"{dx22n:.3e}, request {nccl[0][0]['dp_ms']:.2f} ms; worlds "
          f"{ranks['gloo_s']:.1f} s and {ranks['nccl_s']:.1f} s with "
          f"start-up")

    # 23. tp=2.
    L, w_piv = tpm.column_blocks(N, 2)
    info0, arr0 = gloo[0]
    for info, arr in gloo:
        _check(bool(arr["tp_converged"].all()),
               f"tp: {int(arr['tp_converged'].sum())}/{B} converged")
        _check(np.array_equal(arr["tp_x"], arr0["tp_x"]),
               "tp: the ranks' replicated x differ")
        _check(info["tp_factorizations"] == info0["tp_factorizations"] >= 1
               and info["tp_launches"]
               == info["tp_factorizations"] * L // w_piv,
               f"tp: {info['tp_launches']} leaves for "
               f"{info['tp_factorizations']} factorizations of "
               f"{L // w_piv} panels")
    dx23 = (torch.from_numpy(arr0["tp_x"]).to(dev).double()
            - x64_5).abs().max().item()
    _check(dx23 <= 1e-3, f"tp: max|x - x_f64| = {dx23:.3e}")
    _check(np.array_equal(arr0["tp_local_x"], arr0["tp_x"]),
           "tp: solve_box_qp_tp_local on the rank's blocks differs from "
           "solve_box_qp_tp")
    one = nccl[0][0]["tp1"]
    mem = {k: max(i["tp"][k] for i, _ in gloo) for k in one}
    args_r = mem["args"] / one["args"]
    peak_r = mem["peak"] / one["peak"]
    _check(args_r <= 0.55, f"tp=2 argument bytes {args_r:.3f}x tp=1's")
    _check(peak_r <= 0.7, f"tp=2 peak {peak_r:.3f}x tp=1's")
    tp_ms = [i["tp_ms"] for i, _ in gloo]
    print(f"phase 23 tp=2 ({B}, {N}) f32, gloo on one card: {B}/{B} "
          f"converged in {info0['tp_it']} iterations, max|x - x_f64| "
          f"{dx23:.3e} (<= 1e-3), request {max(tp_ms):.2f} ms (ranks "
          f"{[round(v, 2) for v in tp_ms]}); "
          f"{info0['tp_factorizations']} factorizations x "
          f"{L // w_piv} pivot panels of {w_piv} per rank: leaf launches "
          f"{[i['tp_launches'] for i, _ in gloo]}; warm request on the "
          f"rank's blocks (solve_box_qp_tp_local, x bitwise the whole "
          f"problem's) "
          f"{max(i['tp_warm_ms'] for i, _ in gloo):.2f} ms; one "
          f"factorization (first, warm) "
          f"{[round(v, 2) for v in info0['fact_ms']]} ms; all-reduce of the "
          f"loop's ({B}, {2 * L}) {info0['allreduce_ms']:.3f} ms, panel "
          f"broadcast ({B}, {2 * L}, {w_piv}) {info0['bcast_ms']:.3f} ms, "
          f"flag all-reduce and read {info0['flag_ms']:.3f} ms; the whole "
          f"problem on the host, per rank on the card "
          f"{mem['args'] / 2**20:.1f} MiB of blocks ({args_r:.3f}x tp=1's "
          f"{one['args'] / 2**20:.1f}, <= 0.55), "
          f"{mem['temp'] / 2**20:.1f} MiB above them (tp=1 "
          f"{one['temp'] / 2**20:.1f}), peak of all the rank holds "
          f"{mem['peak'] / 2**20:.1f} MiB ({peak_r:.3f}x tp=1's "
          f"{one['peak'] / 2**20:.1f}, <= 0.7; "
          f"{mem['resident'] / 2**20:.1f} and "
          f"{one['resident'] / 2**20:.1f} MiB held before the blocks)")
    out = {"launches_dp": sum(i["dp_launches"] for i, _ in gloo),
           "launches_tp": sum(i["tp_launches"] for i, _ in gloo),
           "launches_tp_per_rank": [i["tp_launches"] for i, _ in gloo]}
    out.update(_tp_solver_phases(dev, ref, gloo, nccl))
    out.update(_phase_27(dev, ref, gloo, nccl))
    out.update(_phase_28(ref, ranks["train"], ranks["train_s"]))
    return out


def _phase_27(dev, ref, gloo, nccl):
    """Phase 27 from the gloo ranks' records: the tp=2 box ADMM in Cholesky
    mode on phase 13's requests, and OptNet without G on phase 15's."""
    from lqp_py_tpu_torch.parallel.tp_ops import column_blocks

    L, w_piv = column_blocks(N, 2)
    info0, arr0 = gloo[0]
    c = info0["chol"]
    for info, arr in gloo:
        for key in ("chol", "eq"):
            _check(bool(arr[key + "_converged"].all()),
                   f"{key}: {int(arr[key + '_converged'].sum())}/{B} "
                   f"converged")
            _check(np.array_equal(arr[key + "_x"], arr0[key + "_x"]),
                   f"{key}: the ranks' replicated x differ")
        _check(info["chol"]["it"] == c["it"], "tp Cholesky: the ranks' "
               "iteration counts differ")
        _check(info["chol"]["leaves"] == 0, f"tp Cholesky: "
               f"{info['chol']['leaves']} leaf launches")
        _check(info["eq"]["leaves"] == L // w_piv and info["eq"]["it"] == 0,
               f"OptNet tp without G: {info['eq']['leaves']} leaf launches "
               f"(one factorization of {L // w_piv} panels), "
               f"{info['eq']['it']} iterations")
    it13 = ref["it13_chol"]
    _check(abs(c["it"] - it13) <= 0.1 * it13, f"tp Cholesky: {c['it']} "
           f"iterations against phase 13's {it13} (beyond 10%)")
    dx = (torch.from_numpy(arr0["chol_x"]).to(dev).double()
          - ref["x64_5"]).abs().max().item()
    _check(dx <= 1e-3, f"tp Cholesky: max|x - x_f64| = {dx:.3e}")
    one = nccl[0][0]["chol1"]
    mem = {k: max(i["chol_mem"][k] for i, _ in gloo) for k in one}
    args_r, peak_r = mem["args"] / one["args"], mem["peak"] / one["peak"]
    _check(args_r <= 0.55, f"tp Cholesky: blocks {args_r:.3f}x tp=1's")
    _check(peak_r <= 0.7, f"tp Cholesky: peak {peak_r:.3f}x tp=1's")
    x15 = ref["x15"].to(dev)
    deq = ((torch.from_numpy(arr0["eq_x"]).to(dev) - x15).abs().max()
           / x15.abs().max()).item()
    _check(deq <= 1e-4, f"OptNet tp without G vs phase 15's qp_eqcon: "
           f"relative max|dx| {deq:.3e}")
    ms = [round(i["chol"]["ms"], 2) for i, _ in gloo]
    print(f"phase 27 box ADMM tp=2, kkt_solver='cholesky' (phase 13's "
          f"requests: B={B}, n={N}, f32, tol {TOL:g}), gloo on one card "
          f"(staged through the host, not NVLink times), ranks' x bitwise "
          f"equal: {B}/{B} converged in {c['it']} iterations (phase 13's "
          f"Cholesky mode {it13}, within 10%), max|x - x_f64| {dx:.3e} (<= "
          f"1e-3), leaf launches {[i['chol']['leaves'] for i, _ in gloo]}; "
          f"request {max(ms):.2f} ms (ranks {ms}); one column_cholesky "
          f"(first, warm) {[round(v, 2) for v in c['fact_ms']]} ms, one "
          f"iteration's two sweeps ({B}, {2 * L}) {c['sweeps_ms']:.3f} ms; "
          f"the whole problem on the host, per rank on the card "
          f"{mem['args'] / 2**20:.1f} MiB of blocks ({args_r:.3f}x tp=1's "
          f"{one['args'] / 2**20:.1f}, <= 0.55), peak of all the rank holds "
          f"{mem['peak'] / 2**20:.1f} MiB ({peak_r:.3f}x tp=1's "
          f"{one['peak'] / 2**20:.1f}, <= 0.7; {mem['resident'] / 2**20:.1f} "
          f"and {one['resident'] / 2**20:.1f} MiB held before the blocks); "
          f"OptNet tp without G on "
          f"phase 15's requests: {B}/{B} converged, 0 iterations, leaf "
          f"launches {[i['eq']['leaves'] for i, _ in gloo]}, relative "
          f"max|x - x_qp_eqcon| {deq:.3e} (<= 1e-4), request "
          f"{max(i['eq']['ms'] for i, _ in gloo):.2f} ms")
    return {"launches_tp_cholesky": [i["chol"]["leaves"] for i, _ in gloo],
            "launches_tp_optnet_eq": [i["eq"]["leaves"] for i, _ in gloo]}


def _phase_28(ref, train, world_s):
    """Phase 28 from the four ranks of the (2, 2) world: phase 11's ten
    steps through the sharded trainer, and the dry run."""
    t11 = ref["train11"]
    leaves = -(-N_X2 // LEAF)
    losses = [a["losses"] for _, a in train]
    for info, arr in train:
        _check(np.array_equal(arr["losses"], losses[0]),
               "sharded trainer: the ranks' losses differ")
        _check(info["bwd_leaves"] == [leaves] * STEPS2,
               f"sharded trainer: leaf launches per backward "
               f"{info['bwd_leaves']}, expected {leaves} each")
        _check(info["dryrun"], "the dry run did not finish")
    for d in range(2):                         # the tp ranks of a dp shard
        (i0, a0), (i1, a1) = train[2 * d], train[2 * d + 1]
        _check(np.array_equal(a0["x"], a1["x"]) and i0["launches"]
               == i1["launches"], f"sharded trainer: dp shard {d}'s tp "
               f"ranks differ")
    W = torch.from_numpy(np.concatenate([train[0][1]["W"],
                                         train[1][1]["W"]], axis=-1))
    bias = torch.from_numpy(np.concatenate([train[0][1]["bias"],
                                            train[1][1]["bias"]]))

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    gaps = {"loss": float(np.max(np.abs(losses[0] - t11["losses"])
                                 / np.abs(t11["losses"]))),
            "W": rel(W, t11["W"]), "bias": rel(bias, t11["bias"])}
    _check(all(v <= 1e-4 for v in gaps.values()), f"sharded trainer vs "
           f"phase 11: relative gaps {gaps}")
    ms = [i["ms"] / STEPS2 for i, _ in train]
    print(f"phase 28 sharded Experiment-2 trainer (phase 11's: n_x={N_X2}, "
          f"{N_FEAT2} features, minibatch {MINI2} of {N_BATCH2}, lr "
          f"{LR2:g}, tol {TOL:g}, the same initial params and indices), "
          f"four gloo ranks on one card as a (dp=2, tp=2) mesh (staged "
          f"through the host, not NVLink times): {STEPS2} steps through "
          f"make_train_scan_sharded; relative gaps to phase 11's f32 run "
          f"loss {gaps['loss']:.3e}, W {gaps['W']:.3e}, bias "
          f"{gaps['bias']:.3e} (<= 1e-4); tp ranks' x bitwise equal in "
          f"every step, losses bitwise equal on all ranks; leaf launches "
          f"per rank {[i['launches'] for i, _ in train]} ({leaves} per "
          f"backward); ms per step, slowest rank {max(ms):.2f} (ranks "
          f"{[round(v, 2) for v in ms]}); dry run (dryrun_multichip) on the "
          f"same mesh finished on every rank, "
          f"{max(i['dryrun_ms'] for i, _ in train):.2f} ms, leaf launches "
          f"per rank {[i['dryrun_launches'] for i, _ in train]}; world "
          f"{world_s:.1f} s with start-up")
    return {"launches_train_sharded": [i["launches"] for i, _ in train],
            "launches_dryrun": [i["dryrun_launches"] for i, _ in train]}


def _tp_solver_phases(dev, ref, gloo, nccl):
    """Phases 24-26 from the ranks' records (``_tp_solver_worker``): every
    rank converged with x bitwise the other's, x against the float64
    answers of the earlier phases, leaf and GEMV launches per rank, and the
    GenQP memory against tp=1's."""
    from lqp_py_tpu_torch.parallel.tp_ops import column_blocks

    L, w_piv = column_blocks(N, 2)
    per_fact = L // w_piv                 # pivot panels (leaves) per rank
    info0, arr0 = gloo[0]

    def same(key):
        for info, arr in gloo:
            _check(bool(arr[key + "_converged"].all()),
                   f"{key}: {int(arr[key + '_converged'].sum())}/{B} "
                   f"converged")
            _check(np.array_equal(arr[key + "_x"], arr0[key + "_x"]),
                   f"{key}: the ranks' replicated x differ")
            _check(info[key]["it"] == info0[key]["it"],
                   f"{key}: the ranks' iteration counts differ")
        return torch.from_numpy(arr0[key + "_x"]).to(dev)

    def vs64(key, x, x64):
        """max|x - x_f64| per element; within 1e-3 unless the polish was
        rejected (the element kept its interior-point x, bitwise the
        unpolished solve's; phases 16-18), and within 1e-2 always."""
        dev_el = (x.double() - x64.to(dev)).abs().amax(dim=-1)
        kept = torch.from_numpy(
            (arr0[key + "_x"] == arr0[key + "_raw_x"]).all(axis=-1)).to(dev)
        _check(bool(((dev_el <= 1e-3) | kept).all())
               and dev_el.max().item() <= 1e-2,
               f"{key}: max|x - x_f64| {dev_el.max().item():.3e}, "
               f"{int(((dev_el > 1e-3) & ~kept).sum())} beyond 1e-3 with an "
               f"accepted polish")
        return dev_el.max().item(), int((dev_el <= 1e-3).sum()), int(
            kept.sum())

    def ms(key):
        return [round(i[key]["ms"], 2) for i, _ in gloo]

    # 24. GenQP tp=2.
    g = info0["gen"]
    x24 = same("gen")
    for info, _ in gloo:
        _check(info["gen"]["leaves"] == info["gen"]["facts"] * per_fact
               and info["gen"]["facts"] >= 1,
               f"GenQP tp: {info['gen']['leaves']} leaves for "
               f"{info['gen']['facts']} factorizations of {per_fact} panels")
    dx24 = (x24.double() - ref["x64_5"]).abs().max().item()
    _check(dx24 <= 1e-3, f"GenQP tp: max|x - x_f64| = {dx24:.3e}")
    one = nccl[0][0]["gen1"]
    mem = {k: max(i["gen_mem"][k] for i, _ in gloo) for k in one}
    args_r, peak_r = mem["args"] / one["args"], mem["peak"] / one["peak"]
    _check(args_r <= 0.55, f"GenQP tp=2 argument bytes {args_r:.3f}x tp=1's")
    _check(peak_r <= 0.75, f"GenQP tp=2 peak {peak_r:.3f}x tp=1's")
    print(f"phase 24 GenQP tp=2 (phase 19's requests: B={B}, n={N}, G = "
          f"[-I; I], f32, tol {TOL:g}), gloo on one card: {B}/{B} "
          f"converged in {g['it']} iterations (phase 19's {ref['it19']}), "
          f"max|x - x_f64| {dx24:.3e} (<= 1e-3), ranks' x bitwise equal; "
          f"request {max(ms('gen')):.2f} ms (ranks {ms('gen')}); "
          f"{g['facts']} factorizations x {per_fact} panels: leaf launches "
          f"{[i['gen']['leaves'] for i, _ in gloo]}; Gram exchange "
          f"(Gs^T Gs, the other rank's ({B}, {2 * N}, {N - L}) block "
          f"received, {g['received'] / 2**20:.1f} MiB) "
          f"{g['gram_ms']:.2f} ms, one factorization {g['fact_ms']:.2f} ms; "
          f"the whole problem on the host, per rank on the card "
          f"{mem['args'] / 2**20:.1f} MiB of blocks ({args_r:.3f}x tp=1's "
          f"{one['args'] / 2**20:.1f}, <= 0.55), peak of all the rank holds "
          f"{mem['peak'] / 2**20:.1f} MiB ({peak_r:.3f}x tp=1's "
          f"{one['peak'] / 2**20:.1f}, <= 0.75)")

    # 25. The interior points at tp=2.
    lines = []
    for key, x64, want_leaves, what in (
            ("bip", ref["x64_5"],
             lambda it, r: per_fact * (1 + it + r),
             f"box IP (phase 16's requests, n={N})"),
            ("schur", ref["x64_18"],
             lambda it, r: per_fact + -(-N_INEQ // LEAF) * (1 + it)
             + r * per_fact,
             f"OptNet Schur (phase 18's data, n={N}, ni={N_INEQ}; x against "
             f"its condensed float64 answer)"),
            ("cond", ref["x64_cond"],
             lambda it, r: (column_blocks(N_COND, 2)[0]
                            // column_blocks(N_COND, 2)[1]) * (1 + it + r),
             f"OptNet condensed (B={B}, n={N_COND}, G = [-I; I])")):
        x = same(key)
        it = info0[key]["it"]
        for info, _ in gloo:
            r = info["rounds_" + key]
            _check(info[key]["leaves"] == want_leaves(it, r)
                   and r in (2, 3),
                   f"{key}: {info[key]['leaves']} leaf launches, expected "
                   f"{want_leaves(it, r)} for {it} iterations and {r} "
                   f"polish rounds")
        dx, n_in, n_kept = vs64(key, x, x64)
        lines.append(f"{what}: {B}/{B} converged in {it} iterations, "
                     f"{info0['rounds_' + key]} polish rounds, max|x "
                     f"- x_f64| {dx:.3e}, {n_in}/{B} within 1e-3, {n_kept} "
                     f"kept the interior-point x (polish rejected); leaf "
                     f"launches {[i[key]['leaves'] for i, _ in gloo]}; "
                     f"request {max(ms(key)):.2f} ms (ranks {ms(key)})")
    print(f"phase 25 interior points tp=2 (f32, tol {TOL:g}, max_iters 30, "
          f"polish), gloo on one card, ranks' x bitwise equal: "
          + "; ".join(lines))

    # 26. The box ADMM at tp=2 with polish, Anderson and the early-exit
    # step.
    x_pol = same("pol")
    dx26p = (x_pol.double() - ref["x64_5"]).abs().max().item()
    _check(dx26p <= 1e-3, f"tp polish: max|x - x_f64| = {dx26p:.3e}")
    x_lock = same("lock8")
    dx26l = (x_lock - ref["x8"].to(dev)).abs().max().item()
    _check(dx26l <= 1e-2, f"tp lock-step straggler vs phase 8's: max|dx| "
           f"{dx26l:.3e}")
    x_aa, x_early = same("aa8"), same("early8")
    dx26a = (x_aa - x_lock).abs().max().item()
    dx26e = (x_early - x_lock).abs().max().item()
    _check(dx26a <= 1e-2 and dx26e <= 1e-2,
           f"tp straggler vs tp lock-step: Anderson {dx26a:.3e}, early-exit "
           f"{dx26e:.3e} (<= 1e-2)")
    gemv_ranks = [i["early8"]["gemv"] for i, _ in gloo]
    for info, _ in gloo:
        _check(info["early8"]["gemv"] == info["early8"]["it"] > 0
               and info["lock8"]["gemv"] == info["aa8"]["gemv"] == 0,
               f"tp: {info['early8']['gemv']} rectangular GEMV launches for "
               f"{info['early8']['it']} early-exit iterations, "
               f"{info['lock8']['gemv']} lock-step, {info['aa8']['gemv']} "
               f"Anderson")
    print(f"phase 26 box ADMM tp=2, gloo on one card, ranks' x bitwise "
          f"equal: polish on phase 13's requests {info0['pol']['accepted']}/"
          f"{B} accepted, {info0['pol']['it']} iterations, max|x - x_f64| "
          f"{dx26p:.3e} (<= 1e-3), request {max(ms('pol')):.2f} ms; on "
          f"phase 8's straggler batch: lock-step {info0['lock8']['it']} "
          f"iterations (phase 8's {ref['it8']['lock-step']}), max|x - "
          f"x_phase8| {dx26l:.3e} (<= 1e-2), {max(ms('lock8')):.2f} ms; "
          f"Anderson window {AA_WINDOW} {info0['aa8']['it']} iterations, "
          f"max|x - x_lock| {dx26a:.3e}, {max(ms('aa8')):.2f} ms; "
          f"early-exit {info0['early8']['it']} iterations (phase 8's "
          f"{ref['it8']['early-exit']}), max|x - x_lock| {dx26e:.3e} "
          f"(<= 1e-2), {max(ms('early8')):.2f} ms, rectangular GEMV "
          f"launches per rank {gemv_ranks} (one per iteration, on the "
          f"rank's ({B}, {2 * L}, {L}) block of P), frozen rows bitwise "
          f"x_prev in every call: {all(i['early8']['frozen_bitwise'] for i, _ in gloo)}")
    _check(all(i["early8"]["frozen_bitwise"] for i, _ in gloo),
           "tp early-exit: a frozen element's x changed")
    return {"launches_tp_genqp": [i["gen"]["leaves"] for i, _ in gloo],
            "launches_tp_box_ip": [i["bip"]["leaves"] for i, _ in gloo],
            "launches_tp_optnet_schur": [i["schur"]["leaves"]
                                         for i, _ in gloo],
            "launches_tp_optnet_condensed": [i["cond"]["leaves"]
                                             for i, _ in gloo],
            "launches_gemv_tp": sum(gemv_ranks),
            "launches_gemv_tp_per_rank": gemv_ranks}


def _parallel_worker(spec_path, world):
    """One rank of phase 22-23's worlds (``_parallel_phases``): writes its
    numbers to ``<world><rank>.json`` and its arrays to ``.npz``."""
    import torch.distributed as dist

    from lqp_py_tpu_torch import BoxQPConfig, GenQPConfig
    from lqp_py_tpu_torch.ops import collective
    from lqp_py_tpu_torch.ops import linalg as lin
    from lqp_py_tpu_torch.ops.kernels import admm_step as gk
    from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
    from lqp_py_tpu_torch.parallel import (boxqp_sharded,
                                           initialize_distributed,
                                           lowered_tp_memory, make_mesh,
                                           shard_batch, shard_problem_tp,
                                           solve_box_qp_shard_map,
                                           solve_box_qp_sharded,
                                           solve_box_qp_tp,
                                           solve_box_qp_tp_local)
    from lqp_py_tpu_torch.parallel import tp as tpm
    from lqp_py_tpu_torch.parallel import tp_ops
    from lqp_py_tpu_torch.utils.generators import QPData, create_qp_data

    spec = json.loads(Path(spec_path).read_text())
    dev = torch.device(spec["device"], 0)
    if dev.type == "cpu":
        # The CPU rehearsal (tests/test_torch_chip_smoke.py): the kernels'
        # plain versions stand in for them and count as launches.
        def counted(H, out=None):
            sk.LAUNCHES += 1
            return sk.sweep_spd_inverse_ref(H, out)

        def counted_gemv(*a):
            gk.LAUNCHES += 1
            return gk.gemv_early_exit_ref(*a)
        lin.sweep_spd_inverse = counted
        gk.gemv_early_exit = counted_gemv

    def wall(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    def footprint(mesh_tp, host, solver="box", config=None):
        """The tp solve's per-rank memory with the whole problem on the
        host and only the rank's blocks on the card: its arguments, its
        temporaries, and the card's peak over the solve counting every
        tensor the rank holds there (``resident`` before it)."""
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        args, temp = lowered_tp_memory(mesh_tp, *host, solver=solver,
                                       config=config or cfg, device=dev)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else args + temp)
        return {"args": args, "temp": temp, "peak": peak, "resident": held}

    initialize_distributed(backend=None if world == "nccl" else "gloo")
    if world == "train":
        info, arrays = _train_worker(spec, dev, wall)
        _write_rank(spec, world, info, arrays)
        return
    mesh = make_mesh()                   # a world of one rank for "nccl"
    mesh_tp = make_mesh((1, dist.get_world_size()), ("dp", "tp"))
    n, b = spec["N"], spec["B"]
    data = create_qp_data(n, b, seed=0, dtype=torch.float32, device=dev)
    _check(float(data.Q.double().sum()) == spec["q_sum"]
           and float(data.p.double().sum()) == spec["p_sum"],
           "the worker's requests differ from phase 5's")
    cfg = BoxQPConfig(eps_abs=spec["TOL"], eps_rel=spec["TOL"],
                      symmetrize=False)
    info = {"backend": dist.get_backend()}
    arrays = {}
    solve_box_qp_sharded(mesh, *data, config=cfg)            # warm-up
    sk.LAUNCHES, c0 = 0, collective.COLLECTIVES
    sol, info["dp_ms"] = wall(
        lambda: solve_box_qp_sharded(mesh, *data, config=cfg))
    info.update(dp_it=sol.iterations, dp_launches=sk.LAUNCHES,
                dp_collectives=collective.COLLECTIVES - c0)
    arrays.update(dp_x=sol.x, dp_converged=sol.converged)
    if world == "nccl":
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)                 # a collective of the backend
        _check(one.item() == 1.0, "one-rank all-reduce")
        arrays = {k: v.cpu() for k, v in arrays.items()}
        host = tuple(None if x is None else x.cpu() for x in data)
        del data, sol, one
        info["tp1"] = footprint(mesh_tp, host)
        # Phase 27's yardstick: the tp=1 solve in Cholesky mode.
        info["chol1"] = footprint(mesh_tp, host, config=dataclasses.replace(
            cfg, kkt_solver="cholesky"))
        # Phase 24's yardstick: tp=1 GenQP, the whole problem on the host.
        G, h = QPData(*host).with_G_h()
        info["gen1"] = footprint(mesh_tp, (*host[:4], G, h), "genqp",
                                 GenQPConfig(eps_abs=spec["TOL"],
                                             eps_rel=spec["TOL"],
                                             symmetrize=False))
    else:
        sm = solve_box_qp_shard_map(mesh, *data, config=cfg)
        arrays.update(sm_x=sm.x, sm_it=sm.iterations,
                      sm_converged=sm.converged)
        w = torch.randn((b, n), generator=torch.Generator(
            device=dev).manual_seed(W_SEED), device=dev)
        p = data.p.clone().requires_grad_()
        x = boxqp_sharded(mesh, data.Q, p, data.A, data.b, data.lb,
                          data.ub, config=cfg)
        arrays["grad"] = shard_batch(torch.autograd.grad(
            (shard_batch(w, mesh) * x).sum(), p)[0], mesh)
        tp_ops.FACTORIZATIONS, sk.LAUNCHES = 0, 0
        sol, info["tp_ms"] = wall(
            lambda: solve_box_qp_tp(mesh_tp, *data, config=cfg))
        info.update(tp_it=sol.iterations, tp_launches=sk.LAUNCHES,
                    tp_factorizations=tp_ops.FACTORIZATIONS)
        arrays.update(tp_x=sol.x, tp_converged=sol.converged)
        # From here the whole problem stays on the host: the card holds
        # the rank's blocks only (``shard_problem_tp(..., device=)``).
        arrays = {k: v.cpu() for k, v in arrays.items()}
        host = tuple(None if v is None else v.cpu() for v in data)
        del data, sol, sm, x, p, w
        info["tp"] = footprint(mesh_tp, host)
        # Phase 27's, while the rank holds as little as for phase 23's.
        info["chol_mem"] = footprint(mesh_tp, host, config=dataclasses.replace(
            cfg, kkt_solver="cholesky"))
        local = shard_problem_tp(mesh_tp, *host, device=dev)
        sol, info["tp_warm_ms"] = wall(
            lambda: solve_box_qp_tp_local(mesh_tp, *local, config=cfg))
        arrays["tp_local_x"] = sol.x.cpu()
        # The pieces: one factorization of an operand of the solve's shape
        # (Q + I, unscaled), and each collective alone.
        tp = tpm._TP(mesh_tp, "tp", n)
        H = tpm._scaled_block(local[0], torch.ones((b, n), device=dev),
                              torch.ones(b, device=dev), tp)
        info["fact_ms"] = [wall(lambda: tp_ops.column_spd_inverse(
            H, tp, equilibrate=False))[1] for _ in range(2)]
        del H
        y = torch.zeros((b, tp.N), device=dev)
        panel = torch.zeros((b, tp.N, tp.w), device=dev)
        flags = torch.zeros(4, device=dev)
        with collective.batch_group(mesh.get_group("dp")):
            for name, fn in (("allreduce_ms", lambda: tp.sum(y)),
                             ("bcast_ms", lambda: tp.bcast(panel, 0)),
                             ("flag_ms", lambda: collective.batch_max(
                                 flags).tolist())):
                info[name] = statistics.mean(wall(fn)[1]
                                             for _ in range(10))
        del y, panel
        _tp_solver_worker(spec, dev, mesh_tp, host, local, info, arrays,
                          wall, footprint)
    _write_rank(spec, world, info, arrays)


def _write_rank(spec, world, info, arrays):
    """A rank's numbers to ``<world><rank>.json`` and its arrays to
    ``.npz``; then it leaves the world."""
    import torch.distributed as dist

    out = f"{spec['out']}/{world}{dist.get_rank()}"
    Path(out + ".json").write_text(json.dumps(info))
    np.savez(out + ".npz", **{k: (v.detach().cpu() if torch.is_tensor(v)
                                  else torch.as_tensor(v)).numpy()
                              for k, v in arrays.items()})
    dist.destroy_process_group()


def _train_worker(spec, dev, wall):
    """One of phase 28's four ranks, a (dp=2, tp=2) mesh: phase 11's ten
    steps through ``make_train_scan_sharded`` from phase 11's initial
    parameters, indices and data, every backward's leaf launches and every
    step's x recorded; then ``dryrun_multichip`` on the same mesh."""
    from lqp_py_tpu_torch import BoxQPConfig
    from lqp_py_tpu_torch.models import layers
    from lqp_py_tpu_torch.models.train import LinearQP
    from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
    from lqp_py_tpu_torch.parallel import dryrun, make_mesh
    from lqp_py_tpu_torch.parallel import train as ptrain
    from lqp_py_tpu_torch.utils.generators import create_qp_data

    mesh = make_mesh((2, 2), ("dp", "tp"))
    t11 = np.load(f"{spec['out']}/train11.npz")
    n_x = spec["N_X2"]
    data = create_qp_data(n_x, spec["N_BATCH2"], seed=0, dtype=torch.float32,
                          device=dev)
    _check(float(data.Q.double().sum()) == spec["q11_sum"],
           "the worker's training set differs from phase 11's")

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    W0 = on_dev(t11["W0"])
    params = ptrain.shard_linear_qp(LinearQP(W0, torch.zeros_like(W0[0])),
                                    mesh, device=dev)
    run = ptrain.make_train_scan_sharded(
        mesh, BoxQPConfig(eps_abs=spec["TOL"], eps_rel=spec["TOL"]),
        lr=spec["LR2"])
    bwd_leaves, xs = [], []
    bwd_fn, boxqp = layers._boxqp_bwd, ptrain.boxqp

    def counted_bwd(*args, **kw):
        s0 = sk.LAUNCHES
        out = bwd_fn(*args, **kw)
        bwd_leaves.append(sk.LAUNCHES - s0)
        return out

    def spy(*args, **kw):
        x = boxqp(*args, **kw)
        xs.append(x.detach().cpu())
        return x

    layers._boxqp_bwd, ptrain.boxqp = counted_bwd, spy
    try:
        sk.LAUNCHES = 0
        (params, losses), ms = wall(lambda: run(
            params, on_dev(t11["sel"]), on_dev(t11["feats"]), data.Q,
            on_dev(t11["p_true"]), data.A, data.b, data.lb, data.ub))
        launches = sk.LAUNCHES
    finally:
        layers._boxqp_bwd, ptrain.boxqp = bwd_fn, boxqp
    del data
    sk.LAUNCHES = 0
    _, dry_ms = wall(lambda: dryrun.dryrun_multichip(mesh, device=dev))
    info = {"ms": ms, "launches": launches, "bwd_leaves": bwd_leaves,
            "dryrun": True, "dryrun_ms": dry_ms,
            "dryrun_launches": sk.LAUNCHES}
    return info, {"losses": losses, "W": params.W, "bias": params.bias,
                  "x": torch.stack(xs)}


def _tp_solver_worker(spec, dev, mesh_tp, host, local, info, arrays, wall,
                      footprint):
    """The gloo ranks' part of phases 24-26 (``_tp_solver_phases``): the
    tp=2 solves of GenQP, the interior points and the box ADMM's options,
    recorded in ``info`` (per solve: iterations, wall ms, leaf launches,
    factorizations, early-exit GEMV launches) and ``arrays``."""
    from lqp_py_tpu_torch import BoxQPConfig, GenQPConfig, OptNetConfig
    from lqp_py_tpu_torch.models import box_ip, genqp, optnet
    from lqp_py_tpu_torch.ops.kernels import admm_step as gk
    from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
    from lqp_py_tpu_torch.parallel import (shard_problem_tp,
                                           solve_box_qp_ip_tp_local,
                                           solve_box_qp_tp,
                                           solve_box_qp_tp_local,
                                           solve_qp_gen_tp_local,
                                           solve_qp_optnet_tp,
                                           solve_qp_optnet_tp_local)
    from lqp_py_tpu_torch.parallel import tp as tpm
    from lqp_py_tpu_torch.parallel import tp_ops
    from lqp_py_tpu_torch.utils.generators import QPData, create_qp_data

    n, b, tol = spec["N"], spec["B"], spec["TOL"]

    def run(key, fn):
        sk.LAUNCHES = gk.LAUNCHES = tp_ops.FACTORIZATIONS = 0
        sol, ms = wall(fn)
        info[key] = dict(it=sol.iterations, ms=ms, leaves=sk.LAUNCHES,
                         facts=tp_ops.FACTORIZATIONS, gemv=gk.LAUNCHES)
        arrays[key + "_x"] = sol.x.cpu()
        arrays[key + "_converged"] = sol.converged.cpu()
        return sol

    # 24. GenQP on phase 19's requests: its memory with the whole problem
    # on the host, then a request on the rank's blocks.
    cfg_gen = GenQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False)
    host_gen = (*host[:4], *QPData(*host).with_G_h())
    info["gen_mem"] = footprint(mesh_tp, host_gen, "genqp", cfg_gen)
    local_gen = shard_problem_tp(mesh_tp, *host_gen, solver="genqp",
                                 device=dev)
    run("gen", lambda: solve_qp_gen_tp_local(mesh_tp, *local_gen,
                                             config=cfg_gen))
    # Its pieces: the Gram exchange of the rank's G block, and one
    # factorization of an x-step operand of the solve's shape.
    tp = tp_ops._TP(mesh_tp, "tp", n)
    ops = tp_ops.Columns(tp)
    gram, info["gen"]["gram_ms"] = wall(lambda: ops.gram(local_gen[4]))
    info["gen"]["received"] = tp.received
    H = genqp._x_operator(local_gen[0], gram, torch.ones(b, device=dev), 1.0,
                          ops)
    del gram, local_gen
    info["gen"]["fact_ms"] = wall(lambda: ops.inverse(H))[1]
    del H

    # 25. The interior points (Experiment 1's OptNetConfig), each also
    # without polish, to count the elements whose polish was rejected.
    cfg_ip = OptNetConfig(tol=tol, max_iters=30, symmetrize=False)

    def ip(key, fn, config):
        polish = ((box_ip, "box_penalty_polish") if key == "bip"
                  else (optnet, "gen_penalty_polish"))
        _, info["rounds_" + key] = _polish_rounds(
            *polish, lambda: run(key, lambda: fn(config)))
        arrays[key + "_raw_x"] = fn(dataclasses.replace(
            config, polish=False)).x.cpu()

    ip("bip", lambda c: solve_box_qp_ip_tp_local(mesh_tp, *local, config=c),
       cfg_ip)
    args18 = _general_ineq_data(n, b, spec["N_INEQ"], dev)
    _check(float(args18[0].double().sum()) == spec["q18_sum"],
           "the worker's phase-18 data differ from the parent's")
    ip("schur", lambda c: solve_qp_optnet_tp(mesh_tp, *args18, config=c),
       cfg_ip)
    del args18
    dc = create_qp_data(spec["N_COND"], b, seed=0, dtype=torch.float32,
                        device=dev)
    args_c = (*dc[:4], *dc.with_G_h())
    ip("cond", lambda c: solve_qp_optnet_tp(mesh_tp, *args_c, config=c),
       dataclasses.replace(cfg_ip, factor="condensed"))
    del dc, args_c

    # 26. The box ADMM: polish on phase 13's requests (the rank's blocks);
    # phase 8's straggler batch lock-step, with Anderson and with the
    # early-exit step, whose frozen rows are checked in every call.
    cfg = BoxQPConfig(eps_abs=tol, eps_rel=tol, symmetrize=False)
    sol = run("pol", lambda: solve_box_qp_tp_local(
        mesh_tp, *local, config=dataclasses.replace(cfg, polish=True)))
    info["pol"]["accepted"] = int(sol.polished.sum())
    data8 = _straggler_data(n, b, spec["N_HARD"], dev)
    _check(float(data8[0].double().sum()) == spec["q8_sum"],
           "the worker's straggler batch differs from phase 8's")
    base8 = dict(eps_abs=tol, eps_rel=tol, symmetrize=False, max_iters=4000)
    run("lock8", lambda: solve_box_qp_tp(mesh_tp, *data8,
                                         config=BoxQPConfig(**base8)))
    run("aa8", lambda: solve_box_qp_tp(mesh_tp, *data8, config=BoxQPConfig(
        acceleration=spec["AA_WINDOW"], **base8)))
    gemv = tpm._ColumnKKT.gemv
    changed = torch.zeros((), dtype=torch.long, device=dev)

    def spy(self, P, r, x, converged):
        out = gemv(self, P, r, x, converged)
        changed.add_(torch.where(converged[:, None], out != x, False).sum())
        return out

    tpm._ColumnKKT.gemv = spy
    try:
        run("early8", lambda: solve_box_qp_tp(mesh_tp, *data8,
                                              config=BoxQPConfig(
                                                  use_pallas_step=True,
                                                  **base8)))
    finally:
        tpm._ColumnKKT.gemv = gemv
    info["early8"]["frozen_bitwise"] = int(changed) == 0

    # 27. The box ADMM in Cholesky mode on phase 13's requests (the rank's
    # blocks; its memory was taken beside phase 23's), one factorization
    # and one iteration's two sweeps timed; OptNet without G on phase 15's
    # requests (the same blocks).
    cfg_chol = dataclasses.replace(cfg, kkt_solver="cholesky")
    run("chol", lambda: solve_box_qp_tp_local(mesh_tp, *local,
                                              config=cfg_chol))
    H = tpm._scaled_block(local[0], torch.ones((b, n), device=dev),
                          torch.ones(b, device=dev), tp)
    info["chol"]["fact_ms"] = [wall(lambda: tp_ops.column_cholesky(H, tp))[1]
                               for _ in range(2)]
    Lc = tp_ops.column_cholesky(H, tp)
    del H
    y = torch.ones((b, tp.N), device=dev)
    info["chol"]["sweeps_ms"] = statistics.mean(
        wall(lambda: tp_ops.column_chol_solve(Lc, y, tp))[1]
        for _ in range(10))
    del Lc, y
    run("eq", lambda: solve_qp_optnet_tp_local(mesh_tp, *local[:4]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _parallel_worker(*sys.argv[2:4])
    else:
        main()
