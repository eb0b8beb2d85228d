"""The port's sharded Experiment-2 trainer (``parallel/train.py``: W and
bias column-sharded over 'tp', the minibatch over 'dp') held against the
JAX package's ``make_train_step`` and ``make_train_scan`` on the same
numpy data and parameters, on the 2x2, 1x4 and 4x1 layouts; the tp ranks'
solutions bitwise equal within a dp shard; the sharded trainer
checkpointed, restored onto its sharded template and resumed bitwise; and
the port's dry run (``parallel/dryrun.py``) on the 2x2 mesh.  Four gloo
ranks on the CPU, float64.

One launch of four ranks per module runs every case (this file is also the
workers' script: ``python tests/test_torch_parallel_train.py IN.npz
OUTDIR``); the JAX results are computed meanwhile, once.  The sharded loss
sums each shard's objectives and divides by the whole minibatch's size
where JAX takes one mean, so the two agree to rounding, 1e-8, not bitwise.
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
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
# n_x = 30 at t = 4 cuts the columns 8, 8, 8, 6 (the pivot width, not n/t).
N_X, N_FEAT, N_BATCH, MINI, STEPS, LR = 30, 3, 16, 8, 3, 0.05
CFG = dict(eps_abs=1e-9, eps_rel=1e-9, max_iters=50000)
CKPT_STEPS = 8
DATA = ("features", "Q", "p_true", "A", "b", "lb", "ub")


def _inputs():
    import jax
    import jax.numpy as jnp
    from lqp_py_tpu.models.train import init_params
    from lqp_py_tpu.utils.generators import create_qp_data

    d = create_qp_data(N_X, N_BATCH, seed=3, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((N_BATCH, N_FEAT))
    p_true = feats @ rng.standard_normal((N_FEAT, N_X))
    sel = np.stack([rng.choice(N_BATCH, MINI, replace=False)
                    for _ in range(CKPT_STEPS)])
    params = init_params(jax.random.PRNGKey(3), N_FEAT, N_X, jnp.float64)
    Q, _p, A, b, lb, ub = (np.asarray(v, np.float64) for v in d[:6])
    return dict(features=feats, Q=Q, p_true=p_true, A=A, b=b, lb=lb, ub=ub,
                sel=sel, W=np.asarray(params.W), bias=np.asarray(params.bias))


def _jax_results(d):
    import jax.numpy as jnp

    import lqp_py_tpu as J
    from lqp_py_tpu.models.train import (LinearQPParams, make_train_scan,
                                         make_train_step)

    cfg = J.BoxQPConfig(**CFG)
    params = LinearQPParams(W=jnp.asarray(d["W"]),
                            bias=jnp.asarray(d["bias"]))
    full = [jnp.asarray(d[k]) for k in DATA]
    idx = d["sel"][0]
    step1, loss1 = make_train_step(cfg, lr=LR)(params,
                                               *(v[idx] for v in full))
    scan, losses = make_train_scan(cfg, lr=LR)(
        params, jnp.asarray(d["sel"][:STEPS]), *full)
    return {"step": (step1, np.asarray([loss1])),
            "scan": (scan, np.asarray(losses))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from lqp_py_tpu_torch.parallel.launch import launch

    tmp = tmp_path_factory.mktemp("train")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(launch, [sys.executable, __file__,
                                   str(tmp / "in.npz"), str(tmp)],
                          WORLD, timeout_s=LAUNCH_TIMEOUT_S, cwd=str(REPO))
        jax_out = _jax_results(d)
        ranks.result()
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            jax_out, d)


def _whole(per_rank, key, shape):
    """W (f, n) or bias (n,) from the ranks' column blocks, in tp order;
    every dp row holds the same blocks, bitwise."""
    _, t = shape
    for r in range(WORLD):
        np.testing.assert_array_equal(per_rank[r][key],
                                      per_rank[r % t][key])
    return np.concatenate([per_rank[c][key] for c in range(t)], axis=-1)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("run", ["step", "scan"])
def test_sharded_trainer_matches_jax(results, run, layout):
    """One sharded step, and three sharded scan steps: the new W and bias
    and the losses within 1e-8 of JAX's, on every rank."""
    per_rank, j, _ = results
    shape = LAYOUTS[layout]
    params, losses = j[run]
    for r in range(WORLD):
        np.testing.assert_allclose(per_rank[r][f"{run}_{layout}_loss"],
                                   losses, rtol=1e-8, atol=0)
    for key, want in (("W", params.W), ("bias", params.bias)):
        np.testing.assert_allclose(
            _whole(per_rank, f"{run}_{layout}_{key}", shape),
            np.asarray(want), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_trainer_moves_the_weights(results, layout):
    """The comparison is not vacuous: three steps move W."""
    per_rank, _, d = results
    W = _whole(per_rank, f"scan_{layout}_W", LAYOUTS[layout])
    assert np.abs(W - d["W"]).max() > 1e-3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_ranks_solve_bitwise_alike(results, layout):
    """The tp ranks of one dp shard solve the same shard: x bitwise equal,
    in every step of the scan."""
    per_rank, _, _ = results
    _, t = LAYOUTS[layout]
    for r in range(WORLD):
        np.testing.assert_array_equal(per_rank[r][f"x_{layout}"],
                                      per_rank[(r // t) * t][f"x_{layout}"])


def test_shard_linear_qp_cuts_the_tp_columns(results):
    """At t=4, n_x=30 the blocks are 8, 8, 8 and 6 columns wide
    (``tp_columns``), W's and bias's alike."""
    per_rank, _, _ = results
    assert [per_rank[r]["widths_1x4"].tolist() for r in range(WORLD)] == [
        [8, 8], [8, 8], [8, 8], [6, 6]]


def test_sharded_checkpoint_resumes_bitwise(results):
    """Eight sharded scan steps checkpointed after four (each rank its own
    root), restored onto the sharded template and resumed: losses, W and
    bias bitwise the uninterrupted sharded run's."""
    per_rank, _, _ = results
    for r in range(WORLD):
        assert per_rank[r]["ckpt_epoch"] == CKPT_STEPS
        for key in ("losses", "W", "bias"):
            np.testing.assert_array_equal(per_rank[r][f"ckpt_{key}"],
                                          per_rank[r][f"full_{key}"])


def test_dryrun_multichip_finishes_on_the_2x2_mesh(results):
    per_rank, _, _ = results
    assert all(bool(per_rank[r]["dryrun"]) for r in range(WORLD))


def _worker(inp, outdir):
    import torch.distributed as dist

    from lqp_py_tpu_torch import BoxQPConfig
    from lqp_py_tpu_torch.parallel import (initialize_distributed,
                                           make_mesh, shard_batch)
    from lqp_py_tpu_torch.parallel import dryrun
    from lqp_py_tpu_torch.parallel import train as ptrain
    from lqp_py_tpu_torch.utils import checkpoint as ck

    initialize_distributed(backend="gloo", timeout_s=LAUNCH_TIMEOUT_S)
    rank = dist.get_rank()
    d = np.load(inp)
    full = [torch.tensor(d[k]) for k in DATA]
    sel = torch.tensor(d["sel"])
    cfg = BoxQPConfig(**CFG)
    res = {}

    def params(mesh):
        return ptrain.shard_linear_qp(_Params(d["W"], d["bias"]), mesh,
                                      device="cpu")

    xs = []
    boxqp = ptrain.boxqp

    def spy(*a, **kw):
        x = boxqp(*a, **kw)
        xs.append(x.detach().clone())
        return x

    meshes = {k: make_mesh(s, ("dp", "tp")) for k, s in LAYOUTS.items()}
    ptrain.boxqp = spy
    try:
        for layout, mesh in meshes.items():
            step = ptrain.make_train_step_sharded(mesh, cfg, lr=LR)
            mb = shard_batch([v[sel[0]] for v in full], mesh)
            p1, loss = step(params(mesh), *mb)
            res.update({f"step_{layout}_W": p1.W, f"step_{layout}_bias":
                        p1.bias, f"step_{layout}_loss": loss[None]})
            xs.clear()
            run = ptrain.make_train_scan_sharded(mesh, cfg, lr=LR)
            p3, losses = run(params(mesh), sel[:STEPS], *full)
            res.update({f"scan_{layout}_W": p3.W, f"scan_{layout}_bias":
                        p3.bias, f"scan_{layout}_loss": losses,
                        f"x_{layout}": torch.stack(xs)})
    finally:
        ptrain.boxqp = boxqp
    p = params(meshes["1x4"])
    res["widths_1x4"] = [p.W.shape[-1], p.bias.shape[0]]

    # The checkpointed sharded run: each rank its own root and template.
    mesh = meshes["2x2"]
    run = ptrain.make_train_scan_sharded(mesh, cfg, lr=LR)

    def state():
        return ck.init_train_state(params(mesh), CKPT_STEPS,
                                   dtype=torch.float64)

    whole = ck.checkpointed_run(run, state(), sel, *full)
    root = os.path.join(outdir, f"ckpt{rank}")
    ck.checkpointed_run(run, state(), sel[:CKPT_STEPS // 2], *full,
                        root=root, every=CKPT_STEPS // 2)
    resumed = ck.checkpointed_run(
        run, ck.restore_train_state(ck.latest_checkpoint(root), state()),
        sel, *full)
    res.update(full_losses=whole.losses, full_W=whole.params.W,
               full_bias=whole.params.bias, ckpt_losses=resumed.losses,
               ckpt_W=resumed.params.W, ckpt_bias=resumed.params.bias,
               ckpt_epoch=resumed.epoch)

    dryrun.dryrun_multichip(mesh, device="cpu")
    res["dryrun"] = True
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in res.items()})
    dist.destroy_process_group()


class _Params:
    """The JAX package's ``LinearQPParams`` as numpy arrays."""

    def __init__(self, W, bias):
        self.W, self.bias = W, bias


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(*sys.argv[1:3])
