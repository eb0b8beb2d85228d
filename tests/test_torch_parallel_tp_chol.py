"""The port's column-sharded ('tp') box-QP solve in Cholesky KKT mode
(``kkt_solver="cholesky"``) over ``torch.distributed``, held against the
JAX package's ``solve_box_qp_tp`` with the same config
(tests/test_torch_parallel_tp.py's cases, with polish and with Anderson
acceleration too), the distributed blocked Cholesky and its two triangular
sweeps against ``torch.linalg`` on the whole matrix, and the per-rank
memory that proves the factorization is partitioned.  Four gloo ranks on
the CPU, float64.

One launch of four ranks per module runs every case (this file is also the
workers' script: ``python tests/test_torch_parallel_tp_chol.py IN.npz
OUTDIR``); the JAX results are computed meanwhile, once.  Both packages
factor by Cholesky, the port by panels with other summation orders, so x
matches to 1e-8 with equal iteration counts, not bitwise.
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
# case: (n, B, seed, eps, JAX mesh), tests/test_torch_parallel_tp.py's.
CASES = {"n256": (256, 4, 0, 1e-7, (2, 4)),
         "column-layout": (32, 4, 11, 1e-8, (2, 2)),
         "nx1": (1, 4, 13, 1e-9, (4, 1))}
# Options on the n256 case (Anderson at rho_scale 0.01, as the inverse
# mode's test holds it).
OPTIONS = {"polish": dict(polish=True),
           "anderson": dict(acceleration=4, rho_scale=0.01)}
RUNS = {**{c: (c, {}) for c in CASES},
        **{o: ("n256", over) for o, over in OPTIONS.items()}}
# The factorization's checks: n = 250 pads to N = 252 at t = 4 (63-wide
# panels) and to 256 at t = 2 (128-wide), a (B, N, m) right-hand side.
N_FACT, B_FACT, M_RHS = 250, 3, 5
PIECES = ("cholesky", "forward", "backward", "solve", "solve_m")


def _cfg(pkg, eps, **over):
    return pkg.BoxQPConfig(eps_abs=eps, eps_rel=eps, max_iters=50000,
                           kkt_solver="cholesky", **over)


def _inputs():
    import jax.numpy as jnp
    from lqp_py_tpu.utils.generators import create_qp_data
    out = {}
    for case, (n, B, seed, _, _) in CASES.items():
        d = create_qp_data(n, B, seed=seed, dtype=jnp.float64)
        out.update({f"{case}_{k}": np.asarray(v, np.float64)
                    for k, v in zip(BOX, d[:6])})
    rng = np.random.default_rng(8)
    a = rng.standard_normal((B_FACT, 2 * N_FACT, N_FACT))
    out["H"] = a.transpose(0, 2, 1) @ a / (2 * N_FACT) + np.eye(N_FACT)
    out["r"] = rng.standard_normal((B_FACT, N_FACT, M_RHS))
    return out


def _args(d, case):
    a = [d[f"{case}_{k}"] for k in BOX]
    if case == "column-layout":                 # (B, n, 1) vectors
        a = [v if i in (0, 2) else v[..., None] for i, v in enumerate(a)]
    return a


def _jax_results(d):
    import jax.numpy as jnp

    import lqp_py_tpu as J
    from lqp_py_tpu.parallel.mesh import make_mesh
    from lqp_py_tpu.parallel.tp import solve_box_qp_tp

    out = {}
    for run, (case, over) in RUNS.items():
        _, _, _, eps, shape = CASES[case]
        out[run] = solve_box_qp_tp(make_mesh(shape, ("dp", "tp")),
                                   *[jnp.asarray(v) for v in _args(d, case)],
                                   config=_cfg(J, eps, **over))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from lqp_py_tpu_torch.parallel.launch import launch

    tmp = tmp_path_factory.mktemp("tp_chol")
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
@pytest.mark.parametrize("run", list(RUNS))
def test_tp_cholesky_matches_jax(results, run, layout):
    """x to 1e-8 with the JAX package's iteration count, on every rank;
    every element converged."""
    per_rank, j = results
    shape = LAYOUTS[layout]
    for r in range(WORLD):
        assert int(per_rank[r][f"{run}_{layout}_it"]) == int(
            j[run].iterations), (r, run)
    assert _rows(per_rank, f"{run}_{layout}_converged", shape).all()
    np.testing.assert_allclose(_rows(per_rank, f"{run}_{layout}_x", shape),
                               np.asarray(j[run].x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_cholesky_polish_mask_matches_jax(results, layout):
    """The polish accepts the elements whose x it moved in the JAX
    package's Cholesky-mode solve, and some."""
    per_rank, j = results
    moved = np.any(np.asarray(j["polish"].x) != np.asarray(j["n256"].x),
                   axis=-1)
    polished = _rows(per_rank, f"polish_{layout}_polished", LAYOUTS[layout])
    np.testing.assert_array_equal(polished, moved)
    assert polished.any()


@pytest.mark.parametrize("piece", PIECES)
@pytest.mark.parametrize("t", [2, 4])
def test_column_cholesky_and_sweeps_match_torch_linalg(results, t, piece):
    """``column_cholesky``'s block against ``torch.linalg.cholesky`` of the
    whole padded matrix; ``forward_sweep``, ``backward_sweep`` and
    ``column_chol_solve`` (a (B, N) and a (B, N, m) right-hand side)
    against ``solve_triangular`` / ``cholesky_solve``; the sweeps' results
    whole and bitwise alike on every rank."""
    per_rank, _ = results
    ranks = range(t)
    for r in ranks:
        err = per_rank[r][f"fact_t{t}_{piece}_err"]
        assert err < 1e-12, (r, piece, err)
    if piece != "cholesky":
        for r in ranks:
            np.testing.assert_array_equal(per_rank[r][f"fact_t{t}_{piece}"],
                                          per_rank[0][f"fact_t{t}_{piece}"])


def test_column_cholesky_fails_per_element(results):
    """An element that is not SPD turns NaN; the others keep their factor,
    and nothing raises."""
    per_rank, _ = results
    for r in range(WORLD):
        nan = per_rank[r]["nan_elements"]
        assert nan.tolist() == [False, True, False], (r, nan)
        assert per_rank[r]["nan_others_err"] < 1e-12


def test_lowered_tp_memory_partitions(results):
    """At t=4 every rank's operands are < 0.35x and its factorization's
    working set < 0.8x of the t=1 solve's, the gates of the other tp
    solvers' memory tests (n=256, B=4)."""
    per_rank, _ = results
    one = per_rank[0]["mem_t1"]
    for r in range(WORLD):
        args, temp = per_rank[r]["mem_t4"]
        assert args < 0.35 * one[0] and temp < 0.8 * one[1], (r, args, temp)


def _worker(inp, outdir):
    import torch.distributed as dist

    import lqp_py_tpu_torch as T
    from lqp_py_tpu_torch.parallel import (initialize_distributed,
                                           lowered_tp_memory, make_mesh,
                                           solve_box_qp_tp)
    from lqp_py_tpu_torch.parallel import tp as tpm
    from lqp_py_tpu_torch.parallel import tp_ops

    initialize_distributed(backend="gloo", timeout_s=LAUNCH_TIMEOUT_S)
    rank = dist.get_rank()
    d = np.load(inp)
    res = {}
    meshes = {k: make_mesh(s, ("dp", "tp")) for k, s in LAYOUTS.items()}
    for run, (case, over) in RUNS.items():
        args = [torch.tensor(v) for v in _args(d, case)]
        for layout, mesh in meshes.items():
            sol = solve_box_qp_tp(mesh, *args,
                                  config=_cfg(T, CASES[case][3], **over))
            res.update({f"{run}_{layout}_x": sol.x,
                        f"{run}_{layout}_it": sol.iterations,
                        f"{run}_{layout}_converged": sol.converged})
            if sol.polished is not None:
                res[f"{run}_{layout}_polished"] = sol.polished

    # The factorization and the sweeps on the whole padded matrix.
    for t, mesh in ((2, make_mesh((1, 2), ("dp", "tp"))),
                    (4, meshes["1x4"])):
        if mesh.get_coordinate() is None:
            continue
        tp = tpm._TP(mesh, "tp", N_FACT)
        pad = tp.N - N_FACT
        H = torch.nn.functional.pad(torch.tensor(d["H"]), (0, pad, 0, pad))
        H.diagonal(dim1=-2, dim2=-1)[:, N_FACT:] = 1.0
        R = torch.nn.functional.pad(torch.tensor(d["r"]), (0, 0, 0, pad))
        r = R[..., 0].contiguous()
        L = torch.linalg.cholesky(H)
        Lc = tp_ops.column_cholesky(H[:, :, tp.mine].contiguous(), tp)
        tri = torch.linalg.solve_triangular
        got = {"cholesky": Lc,
               "forward": tp_ops.forward_sweep(Lc, r, tp),
               "backward": tp_ops.backward_sweep(Lc, r, tp),
               "solve": tp_ops.column_chol_solve(Lc, r, tp),
               "solve_m": tp_ops.column_chol_solve(Lc, R, tp)}
        want = {"cholesky": L[:, :, tp.mine],
                "forward": tri(L, r[..., None], upper=False)[..., 0],
                "backward": tri(L.mT, r[..., None], upper=True)[..., 0],
                "solve": torch.cholesky_solve(r[..., None], L)[..., 0],
                "solve_m": torch.cholesky_solve(R, L)}
        for piece in PIECES:
            res[f"fact_t{t}_{piece}"] = got[piece]
            res[f"fact_t{t}_{piece}_err"] = (
                (got[piece] - want[piece]).abs().max()
                / want[piece].abs().max()).item()
        if t == 4:
            bad = H.clone()
            bad[1].diagonal()[100] = -1.0
            Lb = tp_ops.column_cholesky(bad[:, :, tp.mine].contiguous(), tp)
            res["nan_elements"] = torch.isnan(Lb).flatten(1).any(dim=-1)
            keep = torch.tensor([0, 2])
            res["nan_others_err"] = (Lb[keep] - L[keep][:, :, tp.mine]).abs(
                ).max().item()

    cfg = _cfg(T, CASES["n256"][3])
    args = [torch.tensor(v) for v in _args(d, "n256")]
    res["mem_t4"] = np.array(lowered_tp_memory(meshes["1x4"], *args,
                                               config=cfg))
    one = make_mesh((1, 1), ("dp", "tp"))        # rank 0 alone
    if one.get_coordinate() is not None:
        res["mem_t1"] = np.array(lowered_tp_memory(one, *args, config=cfg))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(*sys.argv[1:3])
