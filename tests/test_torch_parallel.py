"""Batch-sharded ('dp') solves of the port over ``torch.distributed``, held
against the JAX package's own sharded solves (tests/test_parallel.py's
cases): four gloo ranks on the CPU, float64, numpy data from the JAX
generators.

One launch of four ranks per module runs every case (this file is also the
workers' script: ``python tests/test_torch_parallel.py IN.npz OUTDIR``);
the JAX results are computed meanwhile, once, on the conftest's 8-device
CPU mesh.  In lock step (``solve_box_qp_sharded``, ``boxqp_sharded``,
solvers under ``batch_sharded``) the iteration counts equal the JAX
package's and the values match to 1e-9 (gradients 1e-8, Anderson and the
other solver families 1e-10).  ``solve_box_qp_shard_map`` stops each rank
on its own shard: its per-element iteration counts equal the JAX package's
unsharded solve of that shard.
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
GEN = ("Q", "p", "A", "b", "G", "h")
BOX_TOL = dict(eps_abs=1e-7, eps_rel=1e-7)
GEN_CFG = dict(eps_abs=1e-7, eps_rel=1e-7, max_iters=100000)
IP_CFG = dict(tol=1e-10, max_iters=60)
SOLVERS = ("genqp", "box_ip", "optnet")


def _inputs():
    """Every case's numpy data (tests/test_parallel.py's problems)."""
    import jax.numpy as jnp
    from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
    box = create_qp_data(12, n_batch=16, seed=0, dtype=jnp.float64)
    hard = generate_hard_qp(24, 8, seed=4, dtype=jnp.float64)[:6]
    gen = create_qp_data(24, 8, seed=2, dtype=jnp.float64)
    G, h = gen.with_G_h()
    out = {}
    for pre, names, vals in (("box", BOX, box[:6]), ("hard", BOX, hard),
                             ("ip", BOX, gen[:6]),
                             ("gen", GEN, (*gen[:4], G, h))):
        out.update({f"{pre}_{k}": np.asarray(v, np.float64)
                    for k, v in zip(names, vals)})
    out["w"] = np.random.default_rng(0).normal(size=box.p.shape)
    return out


def _jax_results(d):
    """The JAX package's sharded solves of the same data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import lqp_py_tpu as J
    from lqp_py_tpu.models.box_ip import solve_box_qp_ip
    from lqp_py_tpu.models.genqp import solve_qp_gen
    from lqp_py_tpu.models.optnet import solve_qp_optnet
    from lqp_py_tpu.parallel.mesh import make_mesh
    from lqp_py_tpu.parallel.sharded import (boxqp_sharded,
                                             solve_box_qp_sharded)

    def args(pre, names):
        return [jnp.asarray(d[f"{pre}_{k}"]) for k in names]

    mesh = make_mesh((8,), ("dp",))

    def shard(x):
        return jax.device_put(x, NamedSharding(
            mesh, P("dp", *([None] * (x.ndim - 1)))))

    def jit_sharded(fn, a):
        return jax.jit(fn)(*[shard(v) for v in a])

    cfg = J.BoxQPConfig(**BOX_TOL)
    box = args("box", BOX)
    out = {"dp": solve_box_qp_sharded(mesh, *box, config=cfg)}
    # shard_map's semantics: each of the four ranks solves its rows alone.
    out["shards"] = [J.solve_box_qp(*[v[4 * r:4 * (r + 1)] for v in box],
                                    config=cfg) for r in range(WORLD)]
    w = jnp.asarray(d["w"])
    out["grad"] = jax.grad(lambda p: jnp.sum(w * boxqp_sharded(
        mesh, box[0], p, *box[2:], config=cfg)))(box[1])
    acfg = J.BoxQPConfig(**BOX_TOL, acceleration=8)
    out["anderson"] = jit_sharded(
        lambda *a: J.solve_box_qp(*a, config=acfg), args("hard", BOX))
    gcfg, icfg = J.GenQPConfig(**GEN_CFG), J.OptNetConfig(**IP_CFG)
    out["genqp"] = jit_sharded(lambda *a: solve_qp_gen(*a, config=gcfg),
                               args("gen", GEN))
    out["box_ip"] = jit_sharded(lambda *a: solve_box_qp_ip(*a, config=icfg),
                                args("ip", BOX))
    out["optnet"] = jit_sharded(lambda *a: solve_qp_optnet(*a, config=icfg),
                                args("gen", GEN))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' results, each concatenated over the batch, and the JAX
    package's), the ranks run while the JAX package computes."""
    from lqp_py_tpu_torch.parallel.launch import launch

    tmp = tmp_path_factory.mktemp("dp")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(launch, [sys.executable, __file__,
                                   str(tmp / "in.npz"), str(tmp)],
                          WORLD, timeout_s=LAUNCH_TIMEOUT_S, cwd=str(REPO))
        jax_out = _jax_results(d)
        ranks.result()
    per_rank = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ({k: np.concatenate([p[k] for p in per_rank])
             if per_rank[0][k].ndim else np.array([p[k] for p in per_rank])
             for k in per_rank[0]}, jax_out)


def test_sharded_box_qp_matches_jax(results):
    t, j = results
    assert (t["dp_it"] == int(j["dp"].iterations)).all()
    assert t["dp_converged"].all()
    np.testing.assert_allclose(t["dp_x"], np.asarray(j["dp"].x),
                               rtol=1e-9, atol=1e-12)


def test_sharded_solve_is_one_collective_per_check(results):
    """The lock-step solve all-reduces once per residual check, the
    residual trace's maxima included (plus the flags read before the first
    iteration and the two "any finite bound" flags of the preparation);
    the shard_map solve never."""
    t, _ = results
    assert (t["dp_coll"] == t["dp_checks"] + 3).all()
    assert (t["sm_coll"] == 0).all()


def test_shard_map_matches_jax(results):
    t, j = results
    np.testing.assert_allclose(t["sm_x"], np.asarray(j["dp"].x),
                               rtol=1e-4, atol=1e-6)
    assert t["sm_converged"].all()
    # Per-element counts: each rank's own stopping iteration.
    want = np.concatenate([np.full(4, int(s.iterations))
                           for s in j["shards"]])
    np.testing.assert_array_equal(t["sm_it"], want)


def test_sharded_gradients_match_jax(results):
    t, j = results
    np.testing.assert_allclose(t["grad"], np.asarray(j["grad"]),
                               rtol=1e-8, atol=1e-10)


def test_anderson_sharded_matches_jax(results):
    t, j = results
    assert (t["anderson_it"] == int(j["anderson"].iterations)).all()
    np.testing.assert_allclose(t["anderson_x"], np.asarray(j["anderson"].x),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("solver", SOLVERS)
def test_other_solvers_sharded_match_jax(results, solver):
    t, j = results
    assert (t[f"{solver}_it"] == int(j[solver].iterations)).all()
    np.testing.assert_allclose(t[f"{solver}_x"], np.asarray(j[solver].x),
                               rtol=1e-10, atol=1e-12)


def test_make_mesh_rejects_a_shape_beyond_the_world(results):
    t, _ = results
    assert t["mesh_raises"].all()


def test_launcher_kills_the_world_when_a_rank_fails():
    """One rank fails while the others wait: launch raises at once, with
    every rank's output, and leaves no process behind."""
    from lqp_py_tpu_torch.parallel.launch import LaunchError, launch

    code = ("import os, sys, time\n"
            "print('rank', os.environ['RANK'], os.environ['WORLD_SIZE'],"
            " os.environ['OMP_NUM_THREADS'], flush=True)\n"
            "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)\n")
    with pytest.raises(LaunchError, match="rank 1 exited with 3") as e:
        launch([sys.executable, "-c", code], 3, timeout_s=30)
    assert [o.split()[:4] for o in e.value.outputs] == [
        ["rank", str(r), "3", "1"] for r in range(3)]


def test_launcher_times_out():
    from lqp_py_tpu_torch.parallel.launch import LaunchError, launch

    with pytest.raises(LaunchError, match="timed out"):
        launch([sys.executable, "-c", "import time; time.sleep(60)"], 2,
               timeout_s=1)


def _worker(inp, outdir):
    """One rank: every case on its shard; writes rank<r>.npz."""
    import torch.distributed as dist

    import lqp_py_tpu_torch as T
    from lqp_py_tpu_torch.ops import collective
    from lqp_py_tpu_torch.parallel import (batch_sharded, boxqp_sharded,
                                           initialize_distributed, make_mesh,
                                           shard_batch, solve_box_qp_shard_map,
                                           solve_box_qp_sharded)

    initialize_distributed(backend="gloo")
    rank = dist.get_rank()
    d = np.load(inp)

    def args(pre, names):
        return [torch.tensor(d[f"{pre}_{k}"]) for k in names]

    mesh = make_mesh((WORLD,), ("dp",))
    res = {}
    cfg = T.BoxQPConfig(**BOX_TOL, residual_trace=1000)
    box = args("box", BOX)
    n0 = collective.COLLECTIVES
    s = solve_box_qp_sharded(mesh, *box, config=cfg)
    res.update(dp_x=s.x, dp_it=s.iterations, dp_converged=s.converged,
               dp_coll=collective.COLLECTIVES - n0,
               dp_checks=int((s.residual_trace[:, 0] >= 0).sum()))
    n0 = collective.COLLECTIVES
    s = solve_box_qp_shard_map(mesh, *box, config=T.BoxQPConfig(**BOX_TOL))
    res.update(sm_x=s.x, sm_it=s.iterations, sm_converged=s.converged,
               sm_coll=collective.COLLECTIVES - n0)

    p = box[1].clone().requires_grad_()
    w = shard_batch(torch.tensor(d["w"]), mesh)
    x = boxqp_sharded(mesh, box[0], p, *box[2:], config=cfg)
    res["grad"] = shard_batch(torch.autograd.grad((w * x).sum(), p)[0], mesh)

    s = solve_box_qp_sharded(mesh, *args("hard", BOX), config=T.BoxQPConfig(
        **BOX_TOL, acceleration=8))
    res.update(anderson_x=s.x, anderson_it=s.iterations)
    gen, ip = shard_batch(args("gen", GEN), mesh), shard_batch(
        args("ip", BOX), mesh)
    with batch_sharded(mesh):
        for name, sol in (
                ("genqp", T.solve_qp_gen(*gen, config=T.GenQPConfig(
                    **GEN_CFG))),
                ("box_ip", T.solve_box_qp_ip(*ip, config=T.OptNetConfig(
                    **IP_CFG))),
                ("optnet", T.solve_qp_optnet(*gen, config=T.OptNetConfig(
                    **IP_CFG)))):
            res.update({f"{name}_x": sol.x, f"{name}_it": sol.iterations})
    try:
        make_mesh((2 * WORLD,))
        res["mesh_raises"] = False
    except ValueError:
        res["mesh_raises"] = True
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(*sys.argv[1:3])
