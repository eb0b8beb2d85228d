"""The port's CUDA kernels on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels are
CUDA C++ with no CPU mode; their plain versions are held against the JAX
package in tests/test_torch_linalg.py, tests/test_torch_admm_step.py and
tests/test_torch_block_inverse.py).
This file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, OptNetConfig,
                              boxqp, qp_gen, solve_box_qp, solve_box_qp_ip,
                              solve_qp_gen, solve_qp_optnet)
from lqp_py_tpu_torch.models import box_ip, optnet
from lqp_py_tpu_torch.models import box_qp_grad as grads
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops.kernels import _build
from lqp_py_tpu_torch.ops.kernels import admm_step as gk
from lqp_py_tpu_torch.ops.kernels import block_inverse as bk
from lqp_py_tpu_torch.ops.kernels import mirror as mk
from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
from lqp_py_tpu_torch.utils.generators import create_qp_data

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _leaf_stack(B, device, seed=0, n=128):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((B, 2 * n, n), generator=g, device=device,
                    dtype=torch.float64)
    return ((a.mT @ a) / (2 * n) + torch.eye(n, dtype=torch.float64,
                                             device=device)).float()


@pytest.mark.parametrize("B", [1, 7, 128, 300])
def test_sweep_kernel_matches_plain_version(cuda, B):
    H = _leaf_stack(B, cuda)
    before = sk.LAUNCHES
    out = sk.sweep_spd_inverse(H)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    ref = sk.sweep_spd_inverse_ref(H)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    eye = torch.eye(128, dtype=torch.float64, device=cuda)
    assert (H.double() @ out.double() - eye).abs().max() <= 1e-4


@pytest.mark.parametrize("make", [
    lambda d: _leaf_stack(2, d).double(),
    lambda d: _leaf_stack(2, d).mT,
    lambda d: _leaf_stack(2, d)[:, :64, :64],
    lambda d: _leaf_stack(2, d).as_strided((2, 128, 128), (128 * 128, 64, 1)),
], ids=["float64", "transposed", "wrong-size", "overlapping-rows"])
def test_sweep_kernel_rejects_what_it_does_not_take(cuda, make):
    before = sk.LAUNCHES
    with pytest.raises(ValueError):
        sk.sweep_spd_inverse(make(cuda))
    assert sk.LAUNCHES == before


@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "unaligned"])
def test_sweep_kernel_reads_a_leading_block_view_in_place(cuda, off):
    """A [:, off:off+128, off:off+128] view of a (B, 256, 256) stack, as
    the recursion passes it (off=0: float4 loads; off=1: the scalar path),
    gives bitwise what the kernel gives on its contiguous copy."""
    view = _leaf_stack(5, cuda, n=256)[:, off:off + 128, off:off + 128]
    assert not view.is_contiguous()
    before = sk.LAUNCHES
    out = sk.sweep_spd_inverse(view)
    assert sk.LAUNCHES == before + 1
    assert out.is_contiguous()
    assert torch.equal(out, sk.sweep_spd_inverse(view.contiguous()))


@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dest", ["strided-out", "own-input"])
def test_sweep_kernel_writes_into_a_view(cuda, dest, off):
    """The leaf writing through a diagonal-block view of another stack
    (off=1: scalar stores), or over its own input, gives bitwise what it
    gives into a new stack, and writes nothing outside the view."""
    block = (slice(None), slice(off, off + 128), slice(off, off + 128))
    stack = _leaf_stack(5, cuda, n=256)
    fresh = sk.sweep_spd_inverse(stack[block])
    big = stack if dest == "own-input" else torch.full_like(stack, -7.0)
    want = big.clone()
    want[block] = fresh
    before = sk.LAUNCHES
    out = sk.sweep_spd_inverse(stack[block], out=big[block])
    assert sk.LAUNCHES == before + 1
    assert out.data_ptr() == big[block].data_ptr()
    assert torch.equal(big, want)


@pytest.mark.parametrize("shape", [(3, 512, 512), (2, 100, 37),
                                   (1, 256, 128), (65536, 4, 5)])
def test_mirror_kernel_matches_plain_version(cuda, shape):
    """The top-right block of a stack mirrored into its bottom-left, as
    the recursion does (ragged tiles at 100 x 37; 65536 matrices, one
    more than the grid's z limit): bitwise the plain transposed copy, and
    nothing outside the destination written."""
    B, r, c = shape
    m = r + c + 8
    big = torch.randn((B, m, m), device=cuda)
    want = big.clone()
    mk.mirror_block_ref(want[:, :r, m - c:], want[:, m - c:, :r])
    before = mk.LAUNCHES
    out = mk.mirror_block(big[:, :r, m - c:], big[:, m - c:, :r])
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    assert out.data_ptr() == big[:, m - c:, :r].data_ptr()
    assert torch.equal(big, want)


@pytest.mark.parametrize("make", [
    lambda d: (torch.zeros((2, 8, 4), device=d, dtype=torch.float64),
               torch.zeros((2, 4, 8), device=d, dtype=torch.float64)),
    lambda d: (torch.zeros((2, 8, 4), device=d), torch.zeros((2, 8, 4),
                                                              device=d)),
    lambda d: (torch.zeros((2, 4, 8), device=d).mT, torch.zeros((2, 4, 8),
                                                                device=d)),
], ids=["float64", "wrong-shape", "column-strided"])
def test_mirror_kernel_rejects_what_it_does_not_take(cuda, make):
    before = mk.LAUNCHES
    with pytest.raises(ValueError):
        mk.mirror_block(*make(cuda))
    assert mk.LAUNCHES == before


def test_spd_inverse_fast_assembles_in_one_buffer(cuda, monkeypatch):
    """(4, 1024, 1024): one call of the recursion, 8 leaf launches and 7
    mirrors (one per inner node), and the inverse within 1e-5 of float64,
    relative to its largest entry; the operand is not written."""
    H = _leaf_stack(4, cuda, n=1024)
    before = H.clone()
    calls = []
    rec = lin._schur_inverse
    monkeypatch.setattr(lin, "_schur_inverse",
                        lambda *a, **kw: calls.append(1) or rec(*a, **kw))
    counts = (sk.LAUNCHES, mk.LAUNCHES)
    Hi = lin.spd_inverse_fast(H, equilibrate=False)
    torch.cuda.synchronize()
    assert (len(calls), sk.LAUNCHES - counts[0],
            mk.LAUNCHES - counts[1]) == (1, 8, 7)
    assert torch.equal(H, before)
    inv = torch.linalg.inv(H.double())
    assert (Hi.double() - inv).abs().max() <= 1e-5 * inv.abs().max()


def test_sweep_kernel_ill_conditioned_no_worse_than_plain(cuda):
    """cond ~1e4: the kernel's error against the float64 inverse is at
    most twice the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, _ = torch.linalg.qr(torch.randn((8, 128, 128), generator=g,
                                       device=cuda, dtype=torch.float64))
    lam = torch.logspace(-4, 0, 128, dtype=torch.float64, device=cuda)
    H64 = (q * lam) @ q.mT
    H64 = 0.5 * (H64 + H64.mT)
    H = H64.float()
    inv = torch.linalg.inv(H64)
    err_k = (sk.sweep_spd_inverse(H).double() - inv).abs().max()
    err_p = (sk.sweep_spd_inverse_ref(H).double() - inv).abs().max()
    assert err_k <= 2.0 * err_p, (err_k.item(), err_p.item())


def test_sweep_kernel_keeps_its_tile_in_registers(cuda):
    attrs = _build.kernel_attributes("sweep_spd_inverse")
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["regs"] <= 255, attrs


def test_solve_on_cuda_matches_cpu(cuda):
    data = create_qp_data(200, 8, seed=3, device="cpu")
    cfg = BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False)
    cpu = solve_box_qp(*data, config=cfg)
    before = sk.LAUNCHES
    gpu = solve_box_qp(*(t.to(cuda) for t in data), config=cfg)
    assert sk.LAUNCHES - before >= 2           # two 128 leaves at n=256
    assert bool(gpu.converged.all()) and bool(cpu.converged.all())
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-4


def _gemv_inputs(B, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    P = torch.randn((B, n, n), generator=g, device=device)
    r = torch.randn((B, n), generator=g, device=device)
    x_prev = torch.randn((B, n), generator=g, device=device)
    return P, r, x_prev


def _check_gemv(P, r, x_prev, conv):
    before = gk.LAUNCHES
    out = gk.gemv_early_exit(P, r, x_prev, conv)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    ref = gk.gemv_early_exit_ref(P, r, x_prev, conv)
    assert torch.equal(out[conv], x_prev[conv])
    act = ~conv
    if bool(act.any()):
        err = (out[act] - ref[act]).abs().max()
        assert err <= 1e-5 * ref[act].abs().max(), err.item()


@pytest.mark.parametrize("n", [384, 385, 1000, 1024])
@pytest.mark.parametrize("B", [1, 7, 128, 300])
def test_gemv_kernel_matches_plain_version(cuda, B, n):
    # n = 385 takes the scalar path (rows not 16-byte aligned).  B = 300 is
    # more than the SM count.  Shares converged: none, all but one active,
    # one active, half, all.
    P, r, x_prev = _gemv_inputs(B, n, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    order = torch.randperm(B, generator=g, device=cuda)
    for n_conv in sorted({0, 1, B - 1, B // 2, B}):
        conv = torch.zeros(B, dtype=torch.bool, device=cuda)
        conv[order[:n_conv]] = True
        _check_gemv(P, r, x_prev, conv)


@pytest.mark.parametrize("B", [7, 300])
def test_gemv_kernel_reads_a_misaligned_view(cuda, B):
    """P as a view at a 4-byte offset into its storage: not 16-byte
    aligned, so the kernel takes the scalar path."""
    n = 384
    P, r, x_prev = _gemv_inputs(B, n, cuda)
    flat = torch.empty(B * n * n + 1, device=cuda)
    Pv = flat[1:].view(B, n, n)
    Pv.copy_(P)
    assert Pv.is_contiguous() and Pv.data_ptr() % 16 != 0
    conv = torch.zeros(B, dtype=torch.bool, device=cuda)
    conv[::3] = True
    _check_gemv(Pv, r, x_prev, conv)


def test_gemv_kernel_keeps_no_local_memory(cuda):
    attrs = _build.kernel_attributes("gemv_early_exit")
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["regs"] <= 255, attrs


@pytest.mark.parametrize("m,k", [(1024, 512), (512, 1024), (1000, 500),
                                 (256, 385), (33, 8)])
def test_gemv_kernel_rectangular_matches_plain_version(cuda, m, k):
    """P (B, m, k), the tp step's column block of P: k = 385 takes the
    scalar path; m = 33 leaves a ragged last block of rows."""
    B = 128
    g = torch.Generator(device=cuda).manual_seed(2)
    P = torch.randn((B, m, k), generator=g, device=cuda)
    r = torch.randn((B, k), generator=g, device=cuda)
    x_prev = torch.randn((B, m), generator=g, device=cuda)
    for n_conv in (0, B // 2, B - 1, B):
        conv = torch.zeros(B, dtype=torch.bool, device=cuda)
        conv[:n_conv] = True
        _check_gemv(P, r, x_prev, conv)


@pytest.mark.parametrize("make", [
    lambda P, r, x: (P.double(), r.double(), x.double()),
    lambda P, r, x: (P.mT, r, x),
    lambda P, r, x: (P, r[:, :-1], x),
    lambda P, r, x: (P, r, x[:, :-1]),
], ids=["float64", "non-contiguous", "r-not-P-columns", "x-not-P-rows"])
def test_gemv_kernel_rejects_what_it_does_not_take(cuda, make):
    P, r, x_prev = make(*_gemv_inputs(2, 256, cuda))
    conv = torch.tensor([False, True], device=cuda)
    before = gk.LAUNCHES
    with pytest.raises(ValueError):
        gk.gemv_early_exit(P, r, x_prev, conv)
    assert gk.LAUNCHES == before


def test_early_exit_solve_on_cuda_matches_cpu(cuda):
    data = create_qp_data(200, 8, seed=3, device="cpu")
    cfg = BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False,
                      use_pallas_step=True)
    cpu = solve_box_qp(*data, config=cfg)
    before = gk.LAUNCHES
    gpu = solve_box_qp(*(t.to(cuda) for t in data), config=cfg)
    assert gk.LAUNCHES - before == gpu.iterations
    assert bool(gpu.converged.all()) and bool(cpu.converged.all())
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-4


def _equilibrated_spd(B, n, device, seed=0):
    """(Q + I) of a Wishart Q, Jacobi-equilibrated: the block inverse's
    input contract."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((B, 2 * n, n), generator=g, device=device,
                    dtype=torch.float64)
    H = (a.mT @ a) / (2 * n) + torch.eye(n, dtype=torch.float64,
                                         device=device)
    d = H.diagonal(dim1=-2, dim2=-1).rsqrt()
    return (H * d[:, :, None] * d[:, None, :]).float()


@pytest.mark.parametrize("n", [128, 384, 1024])
@pytest.mark.parametrize("B", [1, 7, 130])
def test_block_inverse_kernel_matches_plain_version(cuda, B, n):
    H = _equilibrated_spd(B, n, cuda)
    before = bk.LAUNCHES
    out = bk.block_spd_inverse(H)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == before + 1
    assert torch.equal(out, out.mT)              # mirrored, not recomputed
    ref = bk.block_spd_inverse_ref(H)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert (H.double() @ out.double() - eye).abs().max() <= 1e-4


def test_block_inverse_kernel_keeps_no_local_memory(cuda):
    attrs = _build.kernel_attributes("block_spd_inverse")
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["regs"] <= 255, attrs


@pytest.mark.parametrize("make", [
    lambda d: _equilibrated_spd(2, 256, d).double(),
    lambda d: _equilibrated_spd(2, 256, d).mT,
    lambda d: _equilibrated_spd(2, 256, d)[:, :200, :200],
], ids=["float64", "non-contiguous", "n-not-128"])
def test_block_inverse_kernel_rejects_what_it_does_not_take(cuda, make):
    before = bk.LAUNCHES
    with pytest.raises(ValueError):
        bk.block_spd_inverse(make(cuda))
    assert bk.LAUNCHES == before


def test_fixed_point_backward_leaf_launches(cuda):
    """One fixed-point backward at n=300: the masked system is padded to
    384 and _schur_solve_rec splits at 128, a 128 leaf and a 256 inverse
    of two: 3 leaf launches.  The layer's gradients on the card match the
    CPU's (plain leaf) on the card forward's residual set, and the CPU
    layer's own gradients."""
    data = create_qp_data(300, 4, seed=5, device="cpu")
    Q, p, A, b, lb, ub = (t.to(cuda) for t in data)
    Q.requires_grad_(True)
    p.requires_grad_(True)
    cfg = BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False)
    x = boxqp(Q, p, A, b, lb, ub, config=cfg)
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    before = sk.LAUNCHES
    gQ, gp = torch.autograd.grad((w.to(cuda) * x).sum(), (Q, p))
    torch.cuda.synchronize()
    assert sk.LAUNCHES - before == 3
    assert bool(torch.isfinite(gQ).all()) and bool(torch.isfinite(gp).all())

    sol = solve_box_qp(*(t.detach() for t in (Q, p, A, b, lb, ub)),
                       config=cfg)
    res = dict(x=sol.x, u=sol.u, lams=sol.lams, nus=sol.nus, Q=Q.detach(),
               A=A, lb=lb, ub=ub, rho=sol.rho)
    direct = grads.box_qp_grad_fixed_point(
        w, **{k: v.cpu() for k, v in res.items()}, reg=cfg.backward_reg)
    Qc, pc = data[0].requires_grad_(True), data[1].requires_grad_(True)
    xc = boxqp(Qc, pc, *data[2:], config=cfg)
    layer = torch.autograd.grad((w * xc).sum(), (Qc, pc))
    for card, cpu, tol in ((gQ, direct[0], 1e-4), (gp, direct[1], 1e-4),
                           (gQ, layer[0], 1e-3), (gp, layer[1], 1e-3)):
        err = (card.cpu() - cpu).abs().max() / cpu.abs().max()
        assert err <= tol, (tuple(cpu.shape), tol, err.item())


@pytest.mark.parametrize("n", [8, 33])
def test_gemv_kernel_above_the_grid_batch_limit(cuda, n):
    """B = 65536 is one more than the grid's y limit: the launch runs in
    chunks and still matches the plain version, frozen rows bitwise.
    n = 33 takes the scalar path."""
    B = 65536
    P, r, x_prev = _gemv_inputs(B, n, cuda, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    order = torch.randperm(B, generator=g, device=cuda)
    for n_conv in (0, B // 3, B):
        conv = torch.zeros(B, dtype=torch.bool, device=cuda)
        conv[order[:n_conv]] = True
        _check_gemv(P, r, x_prev, conv)


def _problem(n, B, seed, device):
    return [t.to(device) for t in create_qp_data(n, B, seed=seed,
                                                 device="cpu")]


def test_unrolled_gradients_on_cuda_match_cpu(cuda):
    """boxqp(unroll=True) at n=200: x and the gradients with respect to Q
    and p on the card against the same call on the CPU; the forward's one
    factorization launches the leaf twice (n=200 pads to 256), the
    backward none."""
    cfg = BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False,
                      unroll=True, unroll_iters=60, adaptive_rho=False)
    out = {}
    for dev in ("cpu", cuda):
        Q, p, A, b, lb, ub = _problem(200, 4, 5, dev)
        Q.requires_grad_(True)
        p.requires_grad_(True)
        before = sk.LAUNCHES
        x = boxqp(Q, p, A, b, lb, ub, config=cfg)
        fwd = sk.LAUNCHES - before
        gQ, gp = torch.autograd.grad(x.square().sum(), (Q, p))
        out[str(dev)] = (x.detach().cpu(), gQ.cpu(), gp.cpu(), fwd,
                         sk.LAUNCHES - before - fwd)
    (xc, gQc, gpc, _, _), (xg, gQg, gpg, fwd, bwd) = out["cpu"], out["cuda"]
    assert (fwd, bwd) == (2, 0)
    assert (xg - xc).abs().max() <= 1e-4
    for g_, c in ((gQg, gQc), (gpg, gpc)):
        assert (g_ - c).norm() <= 1e-3 * c.norm()


@pytest.mark.parametrize("cfg", [dict(polish=True),
                                 dict(kkt_solver="cholesky"),
                                 dict(acceleration=10)],
                         ids=["polish", "cholesky", "anderson"])
def test_solve_options_on_cuda_match_cpu(cuda, cfg):
    data = create_qp_data(200, 8, seed=6, device="cpu")
    config = BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False, **cfg)
    cpu = solve_box_qp(*data, config=config)
    before = sk.LAUNCHES
    gpu = solve_box_qp(*(t.to(cuda) for t in data), config=config)
    leaves = sk.LAUNCHES - before
    if cfg.get("kkt_solver") == "cholesky":
        assert leaves == 0
    else:
        assert leaves >= 2 and leaves % 2 == 0
    assert bool(gpu.converged.all()) and bool(cpu.converged.all())
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-4
    if cfg.get("polish"):
        assert torch.equal(gpu.polished.cpu(), cpu.polished)


IP_CFG = OptNetConfig(tol=1e-5, max_iters=30, symmetrize=False)


def _general_ineq(n, ni, B, seed, device):
    """Random inequalities around a strictly feasible point, one equality
    row (tests/test_optnet.py's construction)."""
    g = torch.Generator().manual_seed(seed)
    L = torch.randn((B, 2 * n, n), generator=g, dtype=torch.float64)
    Q = L.mT @ L / (2 * n) + 0.1 * torch.eye(n, dtype=torch.float64)
    p = torch.randn((B, n), generator=g, dtype=torch.float64)
    A = torch.randn((B, 1, n), generator=g, dtype=torch.float64)
    x0 = torch.randn((B, n), generator=g, dtype=torch.float64)
    G = torch.randn((B, ni, n), generator=g, dtype=torch.float64)
    h = (G @ x0[..., None])[..., 0] + 0.5 + torch.rand(
        (B, ni), generator=g, dtype=torch.float64)
    return [t.float().to(device) for t in (Q, p, A, (A @ x0[..., None])[
        ..., 0], G, h)]


@pytest.mark.parametrize("solver", ["box-ip", "optnet-condensed",
                                    "optnet-schur"])
def test_interior_point_on_cuda_matches_cpu(cuda, solver, monkeypatch):
    """The interior-point solves at n=256, float32, on the card (SWEEP
    kernel) against the same call on the CPU (plain leaf): each n=256
    factorization is two leaf launches, Schur mode's ni=128 block one; a
    polish round (two, or three where round 2 narrowly failed on some
    element) one factorization."""
    module, name = ((box_ip, "box_penalty_polish") if solver == "box-ip"
                    else (optnet, "gen_penalty_polish"))
    real = getattr(module, name)
    out = {}
    for dev in ("cpu", cuda):
        if solver == "optnet-schur":
            args = _general_ineq(256, 128, 4, 9, dev)
        else:
            data = create_qp_data(256, 4, seed=8, device="cpu")
            data = type(data)(*(t.to(dev) for t in data))
            args = (data if solver == "box-ip"
                    else (*data[:4], *data.with_G_h()))
        fn = solve_box_qp_ip if solver == "box-ip" else solve_qp_optnet
        rounds = []

        def counted(*a, **kw):
            rounds.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(module, name, counted)
        before = sk.LAUNCHES
        sol = fn(*args, config=IP_CFG)
        out[str(dev)] = (sol, sk.LAUNCHES - before, len(rounds))
    (cpu, cpu_leaves, _), (gpu, leaves, r) = out["cpu"], out["cuda"]
    assert cpu_leaves == 0 and r in (2, 3)
    it = gpu.iterations
    want = (2 + 1 * (1 + it) + 2 * r if solver == "optnet-schur"
            else 2 * (1 + it + r))
    assert leaves == want
    assert bool(gpu.converged.all()) and bool(cpu.converged.all())
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-4


def test_sweep_kernel_on_an_interior_point_operator(cuda):
    """H = Q + diag(d) with d spanning 1e-8..1e8, as the interior point's
    operator near convergence: spd_inverse_fast (equilibrated, two kernel
    leaves at n=256) no further from a float64 inverse than the same
    recursion with the plain leaf and the plain mirror (no kernel
    launched), beyond a factor 2."""
    Q = create_qp_data(256, 8, seed=10, device="cpu").Q.to(cuda)
    g = torch.Generator().manual_seed(11)
    d = 10.0 ** (16 * torch.rand((8, 256), generator=g) - 8)
    H = Q.clone()
    H.diagonal(dim1=-2, dim2=-1).add_(d.to(cuda))
    inv64 = torch.linalg.inv(H.double())
    before = sk.LAUNCHES
    kern = lin.spd_inverse_fast(H)
    assert sk.LAUNCHES == before + 2
    Hs, de = lin._equilibrate(H)
    launched = (sk.LAUNCHES, mk.LAUNCHES)
    plain = lin._schur_inverse(Hs, leaf=sk.sweep_spd_inverse_ref,
                               mirror=mk.mirror_block_ref)
    assert (sk.LAUNCHES, mk.LAUNCHES) == launched
    plain = plain * de[..., :, None] * de[..., None, :]
    err_k = (kern.double() - inv64).abs().max()
    err_p = (plain.double() - inv64).abs().max()
    assert err_k <= 2 * err_p, (err_k.item(), err_p.item())
    assert err_k <= 1e-4 * inv64.abs().max()


def test_genqp_on_cuda_matches_cpu(cuda):
    """The splitting solver at n=256 with the box as G = [-I; I], float32:
    the forward and the 'kkt' backward (gradients with respect to Q and p)
    on the card against the same calls on the CPU (plain leaf); each
    factorization is two leaf launches, the backward's solve two."""
    cfg = GenQPConfig(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False)
    out = {}
    for dev in ("cpu", cuda):
        data = create_qp_data(256, 4, seed=12, device="cpu")
        data = type(data)(*(t.to(dev) for t in data))
        args = (*data[:4], *data.with_G_h())
        before = sk.LAUNCHES
        sol = solve_qp_gen(*args, config=cfg)
        fwd = sk.LAUNCHES - before
        Q = args[0].clone().requires_grad_(True)
        p = args[1].clone().requires_grad_(True)
        x = qp_gen(Q, p, *args[2:], config=cfg)
        before = sk.LAUNCHES
        gQ, gp = torch.autograd.grad(x.square().sum(), (Q, p))
        out[str(dev)] = (sol, fwd, sk.LAUNCHES - before, gQ.cpu(), gp.cpu())
    (cpu, cpu_fwd, cpu_bwd, gQc, gpc) = out["cpu"]
    (gpu, fwd, bwd, gQg, gpg) = out["cuda"]
    assert cpu_fwd == cpu_bwd == 0
    assert fwd >= 2 and fwd % 2 == 0 and bwd == 2
    assert bool(gpu.converged.all()) and bool(cpu.converged.all())
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-4
    for g_, c in ((gQg, gQc), (gpg, gpc)):
        assert (g_ - c).abs().max() <= 1e-4 * c.abs().max()


# The parallel layer on one card: two gloo ranks (NCCL refuses two ranks on
# one device), started by the port's launcher.
_GLOO_COLLECTIVES = """
import torch, torch.distributed as dist
from lqp_py_tpu_torch.parallel import initialize_distributed
initialize_distributed(backend="gloo")
r = dist.get_rank()
x = torch.full((3, 5), float(r + 1), device="cuda")
dist.all_reduce(x)
assert x.is_cuda and bool((x == 3.0).all()), x
m = torch.tensor([float(r), -float(r)], device="cuda")
dist.all_reduce(m, op=dist.ReduceOp.MAX)
assert m.tolist() == [1.0, 0.0], m
y = torch.arange(6.0, device="cuda") * (r + 1) if r == 1 else torch.empty(
    6, device="cuda")
dist.broadcast(y, src=1)
assert y.tolist() == [2.0 * i for i in range(6)], y
print("ok", r, dist.get_backend())
dist.destroy_process_group()
"""

_TP_FACTORIZATION = """
import torch, torch.distributed as dist
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
from lqp_py_tpu_torch.ops.precision import highest_matmul_precision
from lqp_py_tpu_torch.parallel import initialize_distributed, make_mesh
from lqp_py_tpu_torch.parallel import tp as tpm
from lqp_py_tpu_torch.parallel import tp_ops
initialize_distributed(backend="gloo")
B, n = 8, 1024
g = torch.Generator(device="cuda").manual_seed(5)
a = torch.randn((B, 2 * n, n), generator=g, device="cuda", dtype=torch.float64)
H = ((a.mT @ a) / (2 * n) + torch.eye(n, device="cuda", dtype=torch.float64))
mesh = make_mesh((1, 2), ("dp", "tp"))
tp = tpm._TP(mesh, "tp", n)
with highest_matmul_precision():
    before = sk.LAUNCHES
    got = tp_ops.column_spd_inverse(H.float()[:, :, tp.mine].contiguous(), tp)
    launches = sk.LAUNCHES - before
    ref = lin.spd_inverse_fast(H.float())[:, :, tp.mine]
want = torch.linalg.inv(H)[:, :, tp.mine]
torch.cuda.synchronize()
err = ((got.double() - want).abs().max() / want.abs().max()).item()
err_fast = ((ref.double() - want).abs().max() / want.abs().max()).item()
assert launches == n // 128 // 2, launches
assert err <= max(4 * err_fast, 1e-6), (err, err_fast)
print("ok", dist.get_rank(), launches, err, err_fast)
dist.destroy_process_group()
"""


_TP_CHOLESKY = """
import torch, torch.distributed as dist
from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk
from lqp_py_tpu_torch.ops.precision import highest_matmul_precision
from lqp_py_tpu_torch.parallel import initialize_distributed, make_mesh
from lqp_py_tpu_torch.parallel import tp as tpm
from lqp_py_tpu_torch.parallel import tp_ops
initialize_distributed(backend="gloo")
B, n = 8, 1024
g = torch.Generator(device="cuda").manual_seed(6)
a = torch.randn((B, 2 * n, n), generator=g, device="cuda", dtype=torch.float64)
H = ((a.mT @ a) / (2 * n) + torch.eye(n, device="cuda", dtype=torch.float64))
r = torch.randn((B, n), generator=g, device="cuda", dtype=torch.float64)
mesh = make_mesh((1, 2), ("dp", "tp"))
tp = tpm._TP(mesh, "tp", n)
with highest_matmul_precision():
    before = sk.LAUNCHES
    Lc = tp_ops.column_cholesky(H.float()[:, :, tp.mine].contiguous(), tp)
    x = tp_ops.column_chol_solve(Lc, r.float(), tp)
    launches = sk.LAUNCHES - before
    L32 = torch.linalg.cholesky(H.float())
    x32 = torch.cholesky_solve(r.float()[..., None], L32)[..., 0]
L = torch.linalg.cholesky(H)
want = torch.cholesky_solve(r[..., None], L)[..., 0]
torch.cuda.synchronize()
def rel(a, b):
    return ((a.double() - b).abs().max() / b.abs().max()).item()
err_l, err_l32 = rel(Lc, L[:, :, tp.mine]), rel(L32[:, :, tp.mine], L[:, :, tp.mine])
err_x, err_x32 = rel(x, want), rel(x32, want)
assert launches == 0, launches
assert err_l <= max(4 * err_l32, 1e-6), (err_l, err_l32)
assert err_x <= max(4 * err_x32, 1e-6), (err_x, err_x32)
print("ok", dist.get_rank(), err_l, err_l32, err_x, err_x32)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("code", [_GLOO_COLLECTIVES, _TP_FACTORIZATION,
                                  _TP_CHOLESKY],
                         ids=["gloo-collectives", "tp-factorization",
                              "tp-cholesky"])
def test_two_gloo_ranks_on_one_card(cuda, code):
    """The launcher's two gloo ranks on one card: broadcast and all-reduce
    (sum and max) of CUDA tensors; the tp factorization's local block at
    (8, 1024, 1024) f32, tp=2 (four leaves per rank), against a float64
    inverse, within 4x the error of ``spd_inverse_fast``; and the tp
    Cholesky mode's ``column_cholesky`` and two triangular sweeps at the
    same shape (no leaf), each within 4x the error of
    ``torch.linalg.cholesky`` / ``cholesky_solve`` in f32 against f64."""
    import sys
    from pathlib import Path

    from lqp_py_tpu_torch.parallel.launch import launch

    _build.load_library()            # built once, before the ranks load it
    outs = launch([sys.executable, "-c", code], 2, timeout_s=300,
                  cwd=str(Path(__file__).resolve().parents[1]))
    assert all(o.splitlines()[-1].startswith("ok") for o in outs), outs
