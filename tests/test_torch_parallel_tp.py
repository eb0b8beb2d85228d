"""The port's column-sharded ('tp') box-QP solve over ``torch.distributed``,
held against the JAX package's ``solve_box_qp_tp`` (tests/test_parallel.py's
tp cases; with polish and with Anderson acceleration too), the tp
early-exit step against the one-process early-exit solves of both
packages, with the per-rank memory that proves the factorization is
partitioned, the distributed float32 factorization (the SWEEP leaf's path)
against ``spd_inverse_fast``, and the checkpoint restored onto a template
whose ``W`` is sharded over 'tp'.  Four gloo ranks on the CPU, float64
unless said otherwise.

One launch of four ranks per module runs every case (this file is also the
workers' script: ``python tests/test_torch_parallel_tp.py IN.npz OUTDIR``);
the JAX results are computed meanwhile, once.  The tp solve is a
distributed block sweep where the JAX package partitions a Cholesky
recursion, so x matches to 1e-8 with equal iteration counts, not bitwise.
"""

import concurrent.futures
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
LAUNCH_TIMEOUT_S = 240
BOX = ("Q", "p", "A", "b", "lb", "ub")
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4)}
# case: (n, B, seed, eps, JAX mesh)
CASES = {"n256": (256, 4, 0, 1e-7, (2, 4)),
         "column-layout": (32, 4, 11, 1e-8, (2, 2)),
         "nx1": (1, 4, 13, 1e-9, (4, 1))}
# Options on the n256 case, against JAX's solve_box_qp_tp with the same;
# Anderson at rho_scale 0.01, where ROADMAP Queue 3 holds its parity (far
# from balance the Anderson least squares amplifies rounding differences
# until the float64 iteration counts part).
OPTIONS = {"polish": dict(polish=True),
           "anderson": dict(acceleration=4, rho_scale=0.01)}
# The early-exit step on the straggler batch (tests/test_torch_admm_step.py).
EARLY = dict(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False,
             max_iters=4000, use_pallas_step=True)


def _cfg(pkg, eps, **over):
    return pkg.BoxQPConfig(eps_abs=eps, eps_rel=eps, max_iters=50000,
                           **over)


def _inputs():
    import jax.numpy as jnp
    from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
    out = {}
    for case, (n, B, seed, _, _) in CASES.items():
        d = create_qp_data(n, B, seed=seed, dtype=jnp.float64)
        out.update({f"{case}_{k}": np.asarray(v, np.float64)
                    for k, v in zip(BOX, d[:6])})
    # experiments/experiment_straggler.py's batch: 8 hard problems, all but
    # the last 2 ridged with mean(diag Q) I into easy ones.
    d = [np.asarray(v, np.float64) for v in generate_hard_qp(64, 8)[:6]]
    ridge = np.diagonal(d[0], axis1=-2, axis2=-1).mean(axis=-1)
    d[0] = d[0] + np.where(np.arange(8) < 6, ridge, 0.0)[:, None,
                                                         None] * np.eye(64)
    out.update({f"strag_{k}": v for k, v in zip(BOX, d)})
    return out


def _args(d, case):
    return [d[f"{case}_{k}"] for k in BOX]


def _column(a):
    """The documented (B, n, 1) layout of the vector operands."""
    return [v if i in (0, 2) else v[..., None] for i, v in enumerate(a)]


def _jax_results(d):
    import jax.numpy as jnp

    import lqp_py_tpu as J
    from lqp_py_tpu.parallel.mesh import make_mesh
    from lqp_py_tpu.parallel.tp import solve_box_qp_tp

    out = {}
    for case, (_, _, _, eps, shape) in CASES.items():
        a = _args(d, case)
        if case == "column-layout":
            a = _column(a)
        out[case] = solve_box_qp_tp(make_mesh(shape, ("dp", "tp")),
                                    *[jnp.asarray(v) for v in a],
                                    config=_cfg(J, eps))
    n, _, _, eps, shape = CASES["n256"]
    for name, over in OPTIONS.items():
        out[name] = solve_box_qp_tp(
            make_mesh(shape, ("dp", "tp")),
            *[jnp.asarray(v) for v in _args(d, "n256")],
            config=_cfg(J, eps, **over))
    out["early"] = J.solve_box_qp(*[jnp.asarray(v)
                                    for v in _args(d, "strag")],
                                  config=J.BoxQPConfig(**EARLY))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from lqp_py_tpu_torch.parallel.launch import launch

    tmp = tmp_path_factory.mktemp("tp")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(launch, [sys.executable, __file__,
                                   str(tmp / "in.npz"), str(tmp)],
                          WORLD, timeout_s=LAUNCH_TIMEOUT_S, cwd=str(REPO))
        jax_out = _jax_results(d)
        ranks.result()
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            jax_out)


def _rows(per_rank, key, shape):
    """The batch reassembled from the ranks of a (d, t) layout: ranks of
    one dp row hold the same (replicated) rows; each must say the same."""
    d, t = shape
    for r in range(WORLD):
        np.testing.assert_array_equal(per_rank[r][key],
                                      per_rank[(r // t) * t][key])
    return np.concatenate([per_rank[i * t][key] for i in range(d)])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_box_qp_matches_jax(results, layout):
    per_rank, j = results
    shape = LAYOUTS[layout]
    for r in range(WORLD):
        assert int(per_rank[r][f"{layout}_it"]) == int(j["n256"].iterations)
    assert _rows(per_rank, f"{layout}_converged", shape).all()
    np.testing.assert_allclose(_rows(per_rank, f"{layout}_x", shape),
                               np.asarray(j["n256"].x), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("case", ["column-layout", "nx1"])
def test_tp_layout_cases_match_jax(results, case):
    """(B, n, 1) vectors are canonicalized, and with n = 1 the (B, k, 1)
    matrices stay matrices (their slots are positional)."""
    per_rank, j = results
    shape = CASES[case][4]
    for r in range(WORLD):
        assert int(per_rank[r][f"{case}_it"]) == int(j[case].iterations)
    assert _rows(per_rank, f"{case}_converged", shape).all()
    np.testing.assert_allclose(_rows(per_rank, f"{case}_x", shape),
                               np.asarray(j[case].x), rtol=1e-8,
                               atol=1e-10)


def test_tp_local_blocks_equal_whole_problem(results):
    """``solve_box_qp_tp_local`` on blocks each rank cuts for itself
    (``tp_columns``) gives ``solve_box_qp_tp``'s answer bitwise."""
    per_rank, _ = results
    for r in range(WORLD):
        np.testing.assert_array_equal(per_rank[r]["local_x"],
                                      per_rank[r]["2x2_x"])
        assert int(per_rank[r]["local_it"]) == int(per_rank[r]["2x2_it"])


def test_tp_flags_reduce_over_the_whole_mesh(results):
    """Every residual check of a tp solve all-reduces its flags over all
    dp x tp ranks, so the tp ranks cannot leave the loop apart; a mesh
    smaller than the world gets a group of its own ranks."""
    per_rank, _ = results
    for r in range(WORLD):
        for layout in LAYOUTS:
            assert list(per_rank[r][f"flag_groups_{layout}"]) == [WORLD], (
                r, layout)
        assert int(per_rank[r]["mesh_group_1x2"]) == (2 if r < 2 else 0)


def test_lowered_tp_memory_partitions(results):
    """At t=4 every rank's operands are < 0.35x and its factorization's
    working set < 0.7x of the t=1 solve's (the JAX test's ratios), and no
    operation of the t=4 solve outputs a (B_loc, n, n) tensor."""
    per_rank, _ = results
    n, B = CASES["n256"][:2]
    one = per_rank[0]["mem_t1"]
    for r in range(WORLD):
        args, temp = per_rank[r]["mem_t4"]
        assert args < 0.35 * one[0] and temp < 0.7 * one[1], (r, args, temp)
        assert per_rank[r]["largest_numel_t4"] < B * n * n


def test_tp_float32_factorization_matches_spd_inverse_fast(results):
    """float32 runs the SWEEP leaf (its plain version here) on every pivot
    tile, 64 wide and padded to 128 at t=4, 128 wide at t=2."""
    per_rank, _ = results
    for r in range(WORLD):
        for t in (2, 4):
            assert per_rank[r][f"f32_err_t{t}"] < 2e-5, (
                r, t, per_rank[r][f"f32_err_t{t}"])


def test_restore_onto_tp_sharded_template(results):
    """A state saved unsharded restores onto a template whose W is a
    DTensor sharded over 'tp': the placement stays, and the whole W is the
    saved one bitwise."""
    per_rank, _ = results
    for r in range(WORLD):
        assert per_rank[r]["ckpt_placed"] and per_rank[r]["ckpt_bitwise"]


def test_mesh_groups_take_the_world_timeout(results):
    """A missing peer fails a collective of the mesh's groups after the
    world's timeout, not after torch's default for new groups."""
    per_rank, _ = results
    for r in range(WORLD):
        assert list(per_rank[r]["group_timeouts_s"]) == [LAUNCH_TIMEOUT_S] * 2


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_polish_matches_jax(results, layout):
    """tp with polish: x to 1e-8 of JAX's ``solve_box_qp_tp(polish=True)``
    with its iteration count, and the accepted mask the elements whose x
    the polish moved there (JAX's solution carries no mask)."""
    per_rank, j = results
    shape = LAYOUTS[layout]
    for r in range(WORLD):
        assert int(per_rank[r][f"polish_{layout}_it"]) == int(
            j["polish"].iterations)
    np.testing.assert_allclose(_rows(per_rank, f"polish_{layout}_x", shape),
                               np.asarray(j["polish"].x), rtol=1e-8,
                               atol=1e-10)
    moved = np.any(np.asarray(j["polish"].x) != np.asarray(j["n256"].x),
                   axis=-1)
    polished = _rows(per_rank, f"polish_{layout}_polished", shape)
    np.testing.assert_array_equal(polished, moved)
    assert polished.any()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_anderson_matches_jax(results, layout):
    """tp with Anderson acceleration (on the replicated [z; u], no
    collective of its own): JAX's iteration count and x to 1e-8."""
    per_rank, j = results
    shape = LAYOUTS[layout]
    for r in range(WORLD):
        assert int(per_rank[r][f"anderson_{layout}_it"]) == int(
            j["anderson"].iterations)
    assert _rows(per_rank, f"anderson_{layout}_converged", shape).all()
    np.testing.assert_allclose(
        _rows(per_rank, f"anderson_{layout}_x", shape),
        np.asarray(j["anderson"].x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_early_exit_matches_one_process(results, layout):
    """tp with the early-exit step on the straggler batch: the iterations,
    convergence and x (to 1e-8) of the port's one-process early-exit solve
    and of JAX's ``solve_box_qp(use_pallas_step=True)``; every frozen
    element's x came back from the step bitwise, on every rank."""
    per_rank, j = results
    shape = LAYOUTS[layout]
    for r in range(WORLD):
        assert int(per_rank[r][f"early_{layout}_it"]) == int(
            per_rank[r]["early_one_it"]) == int(j["early"].iterations)
        assert per_rank[r][f"early_{layout}_frozen_bitwise"]
        assert per_rank[r][f"early_{layout}_frozen_rows"] > 0
    conv = _rows(per_rank, f"early_{layout}_converged", shape)
    np.testing.assert_array_equal(conv, np.asarray(j["early"].converged))
    x = _rows(per_rank, f"early_{layout}_x", shape)
    np.testing.assert_allclose(x, per_rank[0]["early_one_x"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(x, np.asarray(j["early"].x), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("frozen", [0.0, 0.5, 1.0],
                         ids=["0%", "50%", "100%"])
def test_rect_gemv_early_exit_matches_matmul(frozen):
    """The early-exit GEMV on a rectangular (B, m, k) P, the tp step's
    block: ``P @ r`` where active, ``x_prev`` bitwise where frozen; on a
    CPU tensor the wrapper takes this plain version."""
    from lqp_py_tpu_torch.ops.kernels import admm_step as gk

    rng = np.random.default_rng(4)
    B, m, k = 8, 96, 40
    P, r, x_prev = (torch.from_numpy(rng.standard_normal(s))
                    for s in ((B, m, k), (B, k), (B, m)))
    conv = torch.arange(B) < round(frozen * B)
    for fn in (gk.gemv_early_exit_ref, gk.gemv_early_exit):
        out = fn(P, r, x_prev, conv)
        assert out.shape == (B, m)
        assert torch.equal(out[conv], x_prev[conv])
        want = torch.einsum("bmk,bk->bm", P, r)
        torch.testing.assert_close(out[~conv], want[~conv], rtol=1e-12,
                                   atol=1e-12)


def _worker(inp, outdir):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._python_dispatch import TorchDispatchMode

    import lqp_py_tpu_torch as T
    from lqp_py_tpu_torch.models.train import LinearQP
    from lqp_py_tpu_torch.ops import collective
    from lqp_py_tpu_torch.ops import linalg as lin
    from lqp_py_tpu_torch.parallel import (initialize_distributed,
                                           lowered_tp_memory, make_mesh,
                                           mesh_group, solve_box_qp_tp,
                                           solve_box_qp_tp_local,
                                           tp_columns)
    from lqp_py_tpu_torch.parallel import tp as tpm
    from lqp_py_tpu_torch.parallel import tp_ops
    from lqp_py_tpu_torch.utils import checkpoint as ck

    initialize_distributed(backend="gloo", timeout_s=LAUNCH_TIMEOUT_S)
    rank = dist.get_rank()
    d = np.load(inp)
    res = {}

    def args(case):
        return [torch.tensor(v) for v in _args(d, case)]

    def record(key, sol):
        res.update({f"{key}_x": sol.x, f"{key}_it": sol.iterations,
                    f"{key}_converged": sol.converged})

    meshes = {k: make_mesh(s, ("dp", "tp")) for k, s in LAYOUTS.items()}
    res["group_timeouts_s"] = [
        meshes["2x2"].get_group(a)._get_backend(torch.device("cpu"))
        .options._timeout.total_seconds() for a in ("dp", "tp")]
    cfg = _cfg(T, CASES["n256"][3])
    batch_max = collective.batch_max
    for layout, mesh in meshes.items():
        sizes = set()

        def spy(t):
            sizes.add(dist.get_world_size(collective._GROUP.get()))
            return batch_max(t)

        collective.batch_max = spy
        try:
            record(layout, solve_box_qp_tp(mesh, *args("n256"), config=cfg))
        finally:
            collective.batch_max = batch_max
        res[f"flag_groups_{layout}"] = sorted(sizes)
    # The rank's own blocks, cut by the rank alone.
    mesh = meshes["2x2"]
    Q, p, A, b, lb, ub = args("n256")
    k = Q.shape[0] // 2                         # rows per dp rank
    rows = slice(mesh.get_local_rank("dp") * k,
                 (mesh.get_local_rank("dp") + 1) * k)
    cols = tp_columns(mesh, Q.shape[-1])
    record("local", solve_box_qp_tp_local(
        mesh, Q[rows, :, cols], p[rows], A[rows, :, cols], b[rows],
        lb[rows], ub[rows], config=cfg))
    half = make_mesh((1, 2), ("dp", "tp"))       # ranks 0 and 1
    res["mesh_group_1x2"] = (dist.get_world_size(mesh_group(half))
                             if half.get_coordinate() is not None else 0)
    for case in ("column-layout", "nx1"):
        a = args(case)
        if case == "column-layout":
            a = _column(a)
        record(case, solve_box_qp_tp(make_mesh(CASES[case][4], ("dp", "tp")),
                                     *a, config=_cfg(T, CASES[case][3])))
    # Polish and Anderson, each layout.
    for name, over in OPTIONS.items():
        for layout, mesh in meshes.items():
            sol = solve_box_qp_tp(mesh, *args("n256"),
                                  config=_cfg(T, CASES["n256"][3], **over))
            record(f"{name}_{layout}", sol)
            if sol.polished is not None:
                res[f"{name}_{layout}_polished"] = sol.polished
    # The early-exit step: every frozen row of each step's result is the x
    # it was given, bitwise.
    gemv = tpm._ColumnKKT.gemv
    for layout, mesh in meshes.items():
        seen = {"rows": 0, "bitwise": True}

        def spy(self, P, r, x, converged):
            out = gemv(self, P, r, x, converged)
            seen["rows"] += int(converged.sum())
            seen["bitwise"] &= torch.equal(out[converged], x[converged])
            return out

        tpm._ColumnKKT.gemv = spy
        try:
            record(f"early_{layout}", solve_box_qp_tp(
                mesh, *args("strag"), config=T.BoxQPConfig(**EARLY)))
        finally:
            tpm._ColumnKKT.gemv = gemv
        res[f"early_{layout}_frozen_rows"] = seen["rows"]
        res[f"early_{layout}_frozen_bitwise"] = seen["bitwise"]
    record("early_one", T.solve_box_qp(*args("strag"),
                                       config=T.BoxQPConfig(**EARLY)))

    res["mem_t4"] = np.array(lowered_tp_memory(meshes["1x4"], *args("n256"),
                                               config=cfg))
    one = make_mesh((1, 1), ("dp", "tp"))        # rank 0 alone
    if one.get_coordinate() is not None:
        res["mem_t1"] = np.array(lowered_tp_memory(one, *args("n256"),
                                                   config=cfg))

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            for o in out if isinstance(out, (tuple, list)) else (out,):
                if torch.is_tensor(o):
                    Largest.numel = max(Largest.numel, o.numel())
            return out

    n = CASES["n256"][0]
    mesh = meshes["1x4"]
    tp = tpm._TP(mesh, "tp", n)
    local = tpm.shard_problem_tp(mesh, *args("n256"))
    with collective.batch_group(mesh.get_group("dp")), Largest():
        tpm._box_local(tp, *local, config=cfg)
    res["largest_numel_t4"] = Largest.numel

    # float32: the block sweep on pivot tiles of the SWEEP leaf.
    Q = torch.tensor(d["n256_Q"], dtype=torch.float32)
    H = Q + torch.eye(n)
    want = torch.linalg.inv(H.double())
    for t, m in ((2, make_mesh((1, 2), ("dp", "tp"))), (4, meshes["1x4"])):
        if m.get_coordinate() is None:
            res[f"f32_err_t{t}"] = 0.0
            continue
        tp = tpm._TP(m, "tp", n)
        got = tp_ops.column_spd_inverse(H[:, :, tp.mine].contiguous(), tp)
        ref = lin.spd_inverse_fast(H)[:, :, tp.mine]
        scale = want.abs().amax()
        res[f"f32_err_t{t}"] = max(
            ((got.double() - want[:, :, tp.mine]).abs().amax()
             / scale).item(),
            ((got - ref).abs().amax() / ref.abs().amax()).item())

    # The sharded checkpoint restore (tests/test_checkpoint.py's).
    mesh = meshes["2x2"]
    g = torch.Generator().manual_seed(3)
    W = torch.randn((4, 8), generator=g, dtype=torch.float64)
    state = ck.init_train_state(LinearQP(W, torch.randn(8, generator=g,
                                                        dtype=torch.float64)),
                                6, dtype=torch.float64)
    path = os.path.join(outdir, f"ck{rank}")
    ck.save_train_state(path, state)
    placements = (Replicate(), Shard(1))
    sharded = torch.distributed.tensor.distribute_tensor(
        torch.zeros_like(W), mesh, placements)
    template = ck.init_train_state(LinearQP(sharded, torch.zeros(
        8, dtype=torch.float64)), 6, dtype=torch.float64)
    restored = ck.restore_train_state(path, template)
    rw = restored.params.W
    res["ckpt_placed"] = (isinstance(rw, DTensor)
                          and tuple(rw.placements) == placements
                          and rw.device_mesh == mesh)
    res["ckpt_bitwise"] = (torch.equal(rw.full_tensor(), W)
                           and torch.equal(restored.params.bias,
                                           state.params.bias))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(*sys.argv[1:3])
