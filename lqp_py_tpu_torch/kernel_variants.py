"""Time text variants of the GEMV and block-inverse CUDA sources on the card.

    python -m lqp_py_tpu_torch.kernel_variants gemv [--parent DIR] [variant ...]
    python -m lqp_py_tpu_torch.kernel_variants block [--parent DIR] [variant ...]

Each variant is a copy of ``csrc/`` under ``build/kernel_variants/`` with
some strings replaced (a constant changed, a phase taken out), built alone
with nvcc into a library of its own and timed at the shape chip_smoke.py
gives the kernel: the GEMV at (128, 1024, 1024) with 0, 90 and 100% of the
batch converged, at 0% in turns with ``P @ r``; the block inverse at
(128, 1024, 1024) on chip_smoke's phase-9 input.  A variant without a phase
computes a wrong result (its error is printed): its time says what the
phase costs.  "base" is the source as it stands.  ``--parent DIR`` also
builds the kernel from ``DIR/lqp_py_tpu_torch/csrc`` (another checkout) and
times it as "parent".

The GEMV is also timed on the traffic it serves: one early-exit solve of
chip_smoke's phase-8 straggler batch records the convergence flags of each
of its GEMV calls, and each library replays those calls on the last call's
operands (device time of the whole replay, stream held), in turns with the
same number of ``P @ r`` calls; then its calls with none and with some of
the batch frozen, apart.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from lqp_py_tpu_torch.ops.kernels import _build

_K = "block_spd_inverse.cu"
_G = "gemv_early_exit.cu"
_WGMMA = ("      wgmma_64x64x8(acc, gmma_desc(alo",
          "      wgmma_64x64x8(acc, gmma_desc(ahi + 8 * k8), gmma_desc(blo",
          "      wgmma_64x64x8(acc, gmma_desc(ahi + 8 * k8), gmma_desc(bhi")
VARIANTS = {
    "gemv": {
        "base": [],
        # P's loads not marked streaming, and blocks of 64 or 16 rows in
        # place of 32.
        "no_streaming": [(_G, "__ldcs(row4 + k)", "__ldg(row4 + k)")],
        "rows_64": [(_G, "kRows = 32", "kRows = 64")],
        "rows_16": [(_G, "kRows = 32", "kRows = 16")],
    },
    "block": {
        "base": [],
        "no_update": [(_K, "    for (int I = 0; I < nb; ++I) {\n      if (I == kb)",
                       "    for (int I = 0; I < 0; ++I) {\n      if (I == kb)")],
        "no_panel": [(_K, "      run_stream(sm, 2 * (nb - 1), [&]",
                      "      run_stream(sm, 0, [&]")],
        "no_sweep": [(_K, "      d.sweep(sm.piv);", "")],
        "no_wgmma": [(_K, w, "      if (0)" + w[5:]) for w in _WGMMA],
        "no_tile_passes": [
            (_K, "      tile_transpose(Mk + I * kB, n, ct", "      if (0) tile_transpose(Mk + I * kB, n, ct"),
            (_K, "      tile_transpose(w + (size_t)J * kB * kB", "      if (0) tile_transpose(w + (size_t)J * kB * kB"),
            (_K, "      tile_copy(w + (size_t)I * kB * kB", "      if (0) tile_copy(w + (size_t)I * kB * kB")],
    },
}
PARENT = "parent"


def variant_sources(kernel, name, csrc=_build.CSRC):
    """{file name: text} of the sources that variant ``name`` edits, with
    its replacements made; raises if a string to replace is not in the
    source."""
    texts = {}
    for fname, old, new in VARIANTS[kernel][name]:
        text = texts.get(fname) or (Path(csrc) / fname).read_text()
        if old not in text:
            raise RuntimeError(f"{kernel}/{name}: {old!r} not in {fname}")
        texts[fname] = text.replace(old, new)
    return texts


def _build_variant(kernel, name, csrc=_build.CSRC):
    out = _build.BUILD_DIR.parent / "kernel_variants" / kernel / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    if name != PARENT:
        for fname, text in variant_sources(kernel, name, csrc).items():
            (out / fname).write_text(text)
    src = out / (_G if kernel == "gemv" else _K)
    lib = out / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
           "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _ms(fn, reps, queued, calls=1):
    """Mean device time of ``fn()`` over ``reps`` calls; with ``queued`` the
    stream is held long enough for the host to enqueue ``reps * calls``
    kernels first."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(reps * calls * 2e5))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _straggler_flags(dev):
    """(flags of each early-exit GEMV call of one straggler solve, the last
    call's P, r, x_prev): chip_smoke.py's phase-8 batch, B=128, n=1000, 8
    hard problems among 120 ridged ones."""
    from lqp_py_tpu_torch import BoxQPConfig, solve_box_qp
    from lqp_py_tpu_torch.ops.kernels import admm_step as gk
    from lqp_py_tpu_torch.utils.generators import generate_hard_qp
    B, n, n_hard = 128, 1000, 8
    hard = generate_hard_qp(n, B, seed=0, dtype=torch.float32, device=dev)
    ridge = hard.Q.diagonal(dim1=-2, dim2=-1).mean(dim=-1)
    easy = torch.arange(B, device=dev) < B - n_hard
    Q = hard.Q + torch.where(easy, ridge, 0.0)[:, None, None] * torch.eye(
        n, device=dev)
    cfg = BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False,
                      max_iters=4000, use_pallas_step=True)
    flags, last = [], []
    kernel = gk.gemv_early_exit

    def spy(P, r, x_prev, converged):
        flags.append(converged.clone().view(torch.uint8))
        last[:] = [P, r.contiguous(), x_prev.contiguous()]
        return kernel(P, r, x_prev, converged)

    gk.gemv_early_exit = spy
    try:
        solve_box_qp(Q, *hard[1:], config=cfg)
    finally:
        gk.gemv_early_exit = kernel
    return flags, last


def _gemv(libs, dev):
    B, n = 128, 1024
    g = torch.Generator(device=dev).manual_seed(7)
    P = torch.randn((B, n, n), generator=g, device=dev)
    r = torch.randn((B, n), generator=g, device=dev)
    x = torch.randn((B, n), generator=g, device=dev)
    order = torch.randperm(B, generator=g, device=dev)
    flags = {}
    for frac in (0.0, 0.9, 1.0):
        c = torch.zeros(B, dtype=torch.bool, device=dev)
        c[order[:round(frac * B)]] = True
        flags[frac] = c.view(torch.uint8)
    out = torch.empty_like(r)
    stream = torch.cuda.current_stream().cuda_stream
    ref = (P @ r[..., None])[..., 0]
    fns = {}
    for name, (lib, regs) in libs.items():
        fn = fns[name] = lib.gemv_early_exit_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]

        def call(frac):
            return lambda: fn(P.data_ptr(), r.data_ptr(), x.data_ptr(),
                              flags[frac].data_ptr(), out.data_ptr(), B, n,
                              stream)

        call(0.0)()
        torch.cuda.synchronize()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        turns = [(_ms(call(0.0), 20, True),
                  _ms(lambda: P @ r[..., None], 20, True)) for _ in range(3)]
        t90 = [_ms(call(0.9), 20, True) for _ in range(3)]
        t100 = _ms(call(1.0), 20, True)
        k0 = sum(k for k, _ in turns) / 3
        print(f"gemv {name}: rel {rel:.1e}; 0% kernel/call ms "
              + ", ".join(f"{k:.4f}/{c:.4f}" for k, c in turns)
              + "; 90% ms " + ", ".join(f"{t:.4f}" for t in t90)
              + f" (90%/0% {sum(t90) / 3 / k0:.3f}); 100% ms {t100:.4f}; "
              f"{regs}", flush=True)
    del P, r, x, out, ref

    # The straggler solve's own calls, replayed by every library in turns
    # (forward, then backward order, twice) with as many P @ r calls.
    sflags, (Ps, rs, xs) = _straggler_flags(dev)
    Bs, ns = rs.shape
    outs = torch.empty_like(rs)
    frozen = sum(int(f.sum()) for f in sflags) / (Bs * len(sflags))

    # The whole solve, and its calls with none and with some frozen.
    parts = {"all": sflags,
             "none frozen": [f for f in sflags if not bool(f.any())],
             "some frozen": [f for f in sflags if bool(f.any())]}

    def replay(fn, fl):
        def run():
            for f in fl:
                fn(Ps.data_ptr(), rs.data_ptr(), xs.data_ptr(), f.data_ptr(),
                   outs.data_ptr(), Bs, ns, stream)
        return run

    def replay_call(fl):
        def run():
            for _ in fl:
                Ps @ rs[..., None]
        return run

    print(f"gemv straggler replay: {len(sflags)} calls at ({Bs},{ns},{ns}), "
          f"mean frozen share {frozen:.4f}; ms per solve", flush=True)
    for part, fl in parts.items():
        runs = {name: replay(fn, fl) for name, fn in fns.items()}
        runs["P @ r"] = replay_call(fl)
        for run in runs.values():
            run()
        times = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]) * 2:
            for name in order:
                times[name].append(_ms(runs[name], 1, True, len(fl)))
        for name, ts in times.items():
            print(f"gemv straggler {part} ({len(fl)} calls) {name}: "
                  + ", ".join(f"{t:.3f}" for t in ts)
                  + f" (mean {sum(ts) / len(ts):.3f})", flush=True)


def _block(libs, dev):
    from lqp_py_tpu_torch.ops.kernels import block_inverse as bk
    from lqp_py_tpu_torch.utils.generators import create_qp_data
    B, n = 128, 1024
    H = create_qp_data(n, B, seed=0, dtype=torch.float32, device=dev).Q
    H.diagonal(dim1=-2, dim2=-1).add_(1.0)
    d = H.diagonal(dim1=-2, dim2=-1).rsqrt()
    H = H * d[:, :, None] * d[:, None, :]
    ref = bk.block_spd_inverse_ref(H)
    out = torch.empty_like(H)
    ct = torch.empty((B, n, bk.BLK), device=dev)
    w = torch.empty_like(ct)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in libs.items():
        fn = lib.block_spd_inverse_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]

        def call():
            rc = fn(H.data_ptr(), out.data_ptr(), ct.data_ptr(),
                    w.data_ptr(), B, n, stream)
            if rc:
                raise RuntimeError(f"block {name}: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        ts = [_ms(call, 3, False) for _ in range(3)]
        print(f"block {name}: rel {rel:.2e}; ms "
              + ", ".join(f"{t:.3f}" for t in ts) + f"; {regs}", flush=True)


def main(argv):
    argv = list(argv)
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = Path(argv[i + 1]) / "lqp_py_tpu_torch" / "csrc"
        del argv[i:i + 2]
    if not argv or argv[0] not in VARIANTS:
        sys.exit(f"usage: python -m lqp_py_tpu_torch.kernel_variants "
                 f"{{{'|'.join(VARIANTS)}}} [--parent DIR] [variant ...]")
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA device")
    kernel, names = argv[0], argv[1:] or list(VARIANTS[argv[0]])
    builds = {name: _build_variant(kernel, name) for name in names}
    if parent is not None:
        builds[PARENT] = _build_variant(kernel, PARENT, parent)
    libs = {}
    for name, (lib, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{kernel}/{name}: nvcc failed\n{log}")
        usage = [ln.split("info    : ")[-1] for ln in log.splitlines()
                 if "spill" in ln or "registers" in ln]
        libs[name] = (ctypes.CDLL(str(lib)), " | ".join(usage[-2:]))
    dev = torch.device("cuda")
    (_gemv if kernel == "gemv" else _block)(libs, dev)


if __name__ == "__main__":
    main(sys.argv[1:])
