"""The port's column-sharded ('tp') GenQP, OptNet (Schur and condensed) and
box-IP solves over ``torch.distributed``, and OptNet without G (the
equality-constrained and unconstrained solves), held against the JAX
package's functions of the same names (tests/test_parallel.py's data and configs),
with each ``*_local`` form on the rank's own blocks and the per-rank memory
that proves the factorizations are partitioned.  Four gloo ranks on the
CPU, float64.

One launch of four ranks per module runs every case (this file is also the
workers' script: ``python tests/test_torch_parallel_tp_gen.py IN.npz
OUTDIR``); the JAX results are computed meanwhile, once.  The tp solves
factor by a distributed block sweep where the JAX package partitions a
Cholesky recursion, so x matches to 1e-8 with equal iteration counts, not
bitwise.  Neither package returns the interior points' or GenQP's polish
acceptance mask, so the mask compared is the one the polish leaves in x:
the elements whose x differs from the same solve's without polish.
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
GEN = ("Q", "p", "A", "b", "G", "h")
BOX = ("Q", "p", "A", "b", "lb", "ub")
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4)}
# solver: (JAX/port tp function, operands, config)
# (tests/test_parallel.py's configs; GenQP polished, as the IPs are)
SOLVERS = {
    "genqp": ("solve_qp_gen_tp", GEN,
              ("GenQPConfig", dict(eps_abs=1e-7, eps_rel=1e-7,
                                   max_iters=100000, polish=True))),
    "optnet-schur": ("solve_qp_optnet_tp", GEN,
                     ("OptNetConfig", dict(tol=1e-10, max_iters=60,
                                           factor="schur"))),
    "optnet-condensed": ("solve_qp_optnet_tp", GEN,
                         ("OptNetConfig", dict(tol=1e-10, max_iters=60,
                                               factor="condensed"))),
    "box_ip": ("solve_box_qp_ip_tp", BOX,
               ("OptNetConfig", dict(tol=1e-10, max_iters=60))),
}
MEMORY = {"genqp": GEN, "optnet": GEN, "box_ip": BOX}
# OptNet without G: the equality-constrained solve, and without A too the
# unconstrained one (the operands given).
NO_G = {"eq": ("Q", "p", "A", "b"), "uncon": ("Q", "p")}


def _cfg(pkg, solver, **over):
    name, kw = SOLVERS[solver][2]
    return getattr(pkg, name)(**{**kw, **over})


def _inputs():
    import jax.numpy as jnp
    from lqp_py_tpu.utils.generators import create_qp_data
    out = {}
    for key, (n, B, seed) in {"small": (64, 4, 5), "big": (256, 2, 6)}.items():
        d = create_qp_data(n, B, seed=seed, dtype=jnp.float64)
        G, h = d.with_G_h()
        for k, v in zip(BOX + ("G", "h"), (*d[:6], G, h)):
            out[f"{key}_{k}"] = np.asarray(v, np.float64)
    return out


def _args(d, names, key="small"):
    return [d[f"{key}_{k}"] for k in names]


def _jax_results(d):
    import jax.numpy as jnp

    import lqp_py_tpu as J
    from lqp_py_tpu.parallel import tp as jtp
    from lqp_py_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((2, 4), ("dp", "tp"))
    out = {}
    for solver, (tp_fn, names, _) in SOLVERS.items():
        a = [jnp.asarray(v) for v in _args(d, names)]
        fn = getattr(jtp, tp_fn)
        out[solver] = fn(mesh, *a, config=_cfg(J, solver))
        out[solver + "_nopolish"] = fn(mesh, *a,
                                       config=_cfg(J, solver, polish=False))
    for case, names in NO_G.items():
        out[case] = jtp.solve_qp_optnet_tp(
            mesh, *[jnp.asarray(v) for v in _args(d, names)])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from lqp_py_tpu_torch.parallel.launch import launch

    tmp = tmp_path_factory.mktemp("tp_gen")
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
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_tp_solver_matches_jax(results, solver, layout):
    """x to 1e-8 with the JAX package's iteration count, on every rank."""
    per_rank, j = results
    shape = LAYOUTS[layout]
    for r in range(WORLD):
        assert int(per_rank[r][f"{solver}_{layout}_it"]) == int(
            j[solver].iterations), (r, solver)
    assert _rows(per_rank, f"{solver}_{layout}_converged", shape).all()
    np.testing.assert_allclose(_rows(per_rank, f"{solver}_{layout}_x", shape),
                               np.asarray(j[solver].x), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", list(NO_G))
def test_tp_optnet_without_g_matches_jax(results, case, layout):
    """``solve_qp_optnet_tp`` without G: x (and with A the equality duals)
    to 1e-8 of JAX's, no iteration, every element converged."""
    per_rank, j = results
    shape = LAYOUTS[layout]
    for r in range(WORLD):
        assert int(per_rank[r][f"{case}_{layout}_it"]) == 0
    assert _rows(per_rank, f"{case}_{layout}_converged", shape).all()
    np.testing.assert_allclose(_rows(per_rank, f"{case}_{layout}_x", shape),
                               np.asarray(j[case].x), rtol=1e-8, atol=1e-10)
    if case == "eq":
        np.testing.assert_allclose(
            _rows(per_rank, f"{case}_{layout}_nus", shape),
            np.asarray(j[case].nus), rtol=1e-8, atol=1e-10)


def test_lowered_tp_memory_optnet_without_g(results):
    """``lowered_tp_memory(solver="optnet")`` without G returns the rank's
    operands and a factorization's working set."""
    per_rank, _ = results
    for r in range(WORLD):
        args, temp = per_rank[r]["mem_optnet_no_g"]
        assert args > 0 and temp > 0, (r, args, temp)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_tp_polish_mask_matches_jax(results, solver):
    """The elements whose x the polish moved are the JAX package's, and
    the polish ran on some of them (the solve without polish differs)."""
    per_rank, j = results
    shape = LAYOUTS["2x2"]
    moved = _rows(per_rank, f"{solver}_moved", shape)
    want = np.any(np.asarray(j[solver].x)
                  != np.asarray(j[solver + "_nopolish"].x), axis=-1)
    np.testing.assert_array_equal(moved, want)
    assert moved.any(), solver


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_tp_local_blocks_equal_whole_problem(results, solver):
    """Each ``*_local`` form on blocks the rank cuts for itself
    (``tp_columns``) gives the whole-problem form's answer bitwise."""
    per_rank, _ = results
    for r in range(WORLD):
        np.testing.assert_array_equal(per_rank[r][f"{solver}_local_x"],
                                      per_rank[r][f"{solver}_2x2_x"])
        assert int(per_rank[r][f"{solver}_local_it"]) == int(
            per_rank[r][f"{solver}_2x2_it"])


@pytest.mark.parametrize("solver", list(MEMORY))
def test_lowered_tp_memory_partitions(results, solver):
    """At t=4 every rank's operands are < 0.35x and its temporaries (the
    largest factorization working set plus the largest received G block)
    < 0.8x of the t=1 solve's, as tests/test_parallel.py holds GSPMD's
    (n=256, B=2)."""
    per_rank, _ = results
    one = per_rank[0][f"mem_{solver}_t1"]
    for r in range(WORLD):
        args, temp = per_rank[r][f"mem_{solver}_t4"]
        assert args < 0.35 * one[0] and temp < 0.8 * one[1], (
            r, solver, args, temp, one)


def test_tp_gram_block_receives_other_ranks_columns(results):
    """The Gram exchange at t=4 receives three (B, 2n, n/4) blocks of G;
    at t=1 none."""
    per_rank, _ = results
    for r in range(WORLD):
        assert int(per_rank[r]["received_t4"]) == 2 * 512 * 64 * 8
    assert int(per_rank[0]["received_t1"]) == 0


def _worker(inp, outdir):
    import torch.distributed as dist

    import lqp_py_tpu_torch as T
    from lqp_py_tpu_torch.parallel import (initialize_distributed,
                                           lowered_tp_memory, make_mesh,
                                           tp_columns)
    from lqp_py_tpu_torch.parallel import tp as tpm

    initialize_distributed(backend="gloo", timeout_s=LAUNCH_TIMEOUT_S)
    rank = dist.get_rank()
    d = np.load(inp)
    res = {}
    meshes = {k: make_mesh(s, ("dp", "tp")) for k, s in LAYOUTS.items()}
    for solver, (tp_fn, names, _) in SOLVERS.items():
        args = [torch.tensor(v) for v in _args(d, names)]
        fn = getattr(T.parallel, tp_fn)
        for layout, mesh in meshes.items():
            sol = fn(mesh, *args, config=_cfg(T, solver))
            res.update({f"{solver}_{layout}_x": sol.x,
                        f"{solver}_{layout}_it": sol.iterations,
                        f"{solver}_{layout}_converged": sol.converged})
        # The polish's mask: x moved against the same tp solve without it.
        mesh = meshes["2x2"]
        plain = fn(mesh, *args, config=_cfg(T, solver, polish=False))
        res[f"{solver}_moved"] = torch.any(
            res[f"{solver}_2x2_x"] != plain.x, dim=-1)
        # The rank's own blocks, cut by the rank alone.
        k = args[0].shape[0] // 2                   # rows per dp rank
        dp = mesh.get_local_rank("dp")
        rows = slice(dp * k, (dp + 1) * k)
        cols = tp_columns(mesh, args[0].shape[-1])
        mats = (0, 2, 4) if names == GEN else (0, 2)
        local = [a[rows][..., cols] if i in mats else a[rows]
                 for i, a in enumerate(args)]
        sol = getattr(T.parallel, tp_fn + "_local")(
            mesh, *local, config=_cfg(T, solver))
        res.update({f"{solver}_local_x": sol.x,
                    f"{solver}_local_it": sol.iterations})

    for case, names in NO_G.items():
        args = [torch.tensor(v) for v in _args(d, names)]
        for layout, mesh in meshes.items():
            sol = T.parallel.solve_qp_optnet_tp(mesh, *args)
            res.update({f"{case}_{layout}_x": sol.x,
                        f"{case}_{layout}_it": sol.iterations,
                        f"{case}_{layout}_converged": sol.converged})
            if sol.nus is not None:
                res[f"{case}_{layout}_nus"] = sol.nus
    res["mem_optnet_no_g"] = np.array(lowered_tp_memory(
        meshes["1x4"], *[torch.tensor(v) for v in _args(d, NO_G["eq"])],
        solver="optnet"))

    # Memory at n=256, B=2: t=4 on every rank, t=1 on rank 0 alone.
    mesh1 = make_mesh((1, 1), ("dp", "tp"))
    for solver, names in MEMORY.items():
        args = [torch.tensor(v) for v in _args(d, names, "big")]
        cfg = _cfg(T, solver if solver != "optnet" else "optnet-condensed")
        res[f"mem_{solver}_t4"] = np.array(lowered_tp_memory(
            meshes["1x4"], *args, config=cfg, solver=solver))
        if mesh1.get_coordinate() is not None:
            res[f"mem_{solver}_t1"] = np.array(lowered_tp_memory(
                mesh1, *args, config=cfg, solver=solver))

    # The Gram exchange's received blocks.
    G = torch.tensor(d["big_G"])
    for t, mesh in ((4, meshes["1x4"]), (1, mesh1)):
        if mesh.get_coordinate() is None:
            continue
        tp = tpm._TP(mesh, "tp", G.shape[-1])
        tpm.Columns(tp).gram(G[..., tp_columns(mesh, G.shape[-1])]
                             .contiguous())
        res[f"received_t{t}"] = tp.received
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(*sys.argv[1:3])
