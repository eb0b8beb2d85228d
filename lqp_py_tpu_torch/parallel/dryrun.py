"""A dry run of the distribution layer: one sharded training step and a
solve of every flagship entry point on a ('dp', 'tp') mesh, at tiny shapes
(the counterpart of ``__graft_entry__.py``).

    python -m lqp_py_tpu_torch.parallel.launch --nproc 4 -- \\
        python -m lqp_py_tpu_torch.parallel.dryrun [--device cpu] \\
        [--backend gloo]

Each rank joins the launcher's world, builds a (world/2, 2) mesh (tp = 2
where the world is even, else 1) and runs ``entry()``'s solve and
``dryrun_multichip``.  Several ranks on one card need ``--backend gloo``
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import argparse
import sys

import torch
from torch.distributed.device_mesh import DeviceMesh

from lqp_py_tpu_torch.config import BoxQPConfig, GenQPConfig
from lqp_py_tpu_torch.models.box_qp import solve_box_qp
from lqp_py_tpu_torch.models.train import init_params
from lqp_py_tpu_torch.parallel.mesh import (initialize_distributed,
                                            make_mesh, shard_batch)
from lqp_py_tpu_torch.parallel.sharded import (solve_box_qp_shard_map,
                                               solve_box_qp_sharded)
from lqp_py_tpu_torch.parallel.tp import solve_box_qp_tp, solve_qp_gen_tp
from lqp_py_tpu_torch.parallel.train import (make_train_step_sharded,
                                             shard_linear_qp)
from lqp_py_tpu_torch.utils.convert import CUDA
from lqp_py_tpu_torch.utils.generators import create_qp_data


def _finite(name, x):
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"dry run: {name} is not finite")


def entry(device=CUDA):
    """``(fn, example_args)``: the box-QP forward solve at the dry run's
    single-device shape (B=8, n=64, float32, tol 1e-5)."""
    config = BoxQPConfig(eps_abs=1e-5, eps_rel=1e-5)
    data = create_qp_data(n_x=64, n_batch=8, seed=0, dtype=torch.float32,
                          device=device)

    def fn(Q, p, A, b, lb, ub):
        return solve_box_qp(Q, p, A, b, lb, ub, config).x

    return fn, tuple(data)


def dryrun_multichip(mesh: DeviceMesh, device=CUDA) -> None:
    """On a ('dp', 'tp') ``mesh`` over the first ranks of the world, every
    rank of which calls this: one SGD step of the sharded trainer (W and
    bias over 'tp', the batch over 'dp'), the tp box and GenQP solves, a
    shard_map solve on a dp mesh of every rank of ``mesh`` and an Anderson
    (window 4) lock-step dp solve, each result checked finite.  The shapes
    of ``__graft_entry__.dryrun_multichip``: n_x=16, 4 features, a batch of
    2 per dp rank, float32."""
    dp = mesh.shape[mesh.mesh_dim_names.index("dp")]
    n_x, n_features, n_batch = 16, 4, 2 * dp
    kw = dict(dtype=torch.float32, device=device)
    data = create_qp_data(n_x=n_x, n_batch=n_batch, seed=0, **kw)
    g = torch.Generator(device=device).manual_seed(0)
    features = torch.randn((n_batch, n_features), generator=g, **kw)
    params = init_params(n_features, n_x, generator=torch.Generator(
        device=device).manual_seed(1), **kw)
    config = BoxQPConfig(eps_abs=1e-4, eps_rel=1e-4, max_iters=200)

    step = make_train_step_sharded(mesh, config, lr=5e-4)
    local = shard_linear_qp(params, mesh, device=device)
    local, loss = step(local, *shard_batch((features, *data), mesh))
    _finite("the sharded step's loss", loss)
    _finite("the sharded step's W", local.W)

    _finite("solve_box_qp_tp x", solve_box_qp_tp(mesh, *data,
                                                 config=config).x)
    G, h = data.with_G_h()
    gcfg = GenQPConfig(eps_abs=1e-4, eps_rel=1e-4, max_iters=2000)
    _finite("solve_qp_gen_tp x", solve_qp_gen_tp(
        mesh, data.Q, data.p, data.A, data.b, G, h, config=gcfg).x)

    dp_mesh = make_mesh((mesh.size(),), ("dp",))
    _finite("solve_box_qp_shard_map x", solve_box_qp_shard_map(
        dp_mesh, *data, config=config).x)

    aa = BoxQPConfig(eps_abs=1e-4, eps_rel=1e-4, max_iters=200,
                     acceleration=4)
    _finite("the Anderson dp solve's x",
            solve_box_qp_sharded(mesh, *data, config=aa).x)


def main(args=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", default=None,
                    help="the world's backend (default: nccl on the card, "
                         "gloo on the CPU)")
    ns = ap.parse_args(args)
    if ns.device == "cuda" and not torch.cuda.is_available():
        print("dry run: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    initialize_distributed(backend=ns.backend or (
        "gloo" if ns.device == "cpu" else None))
    device = (torch.device("cuda", torch.cuda.current_device())
              if ns.device == "cuda" else torch.device("cpu"))
    world = torch.distributed.get_world_size() if (
        torch.distributed.is_initialized()) else 1
    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh((world // tp, tp), ("dp", "tp"))
    fn, example = entry(device)
    x = fn(*example)
    _finite("entry x", x)
    print(f"entry ok: {tuple(x.shape)} {x.abs().max().item():.6g}")
    dryrun_multichip(mesh, device)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
