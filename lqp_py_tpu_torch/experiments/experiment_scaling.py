"""Batch-sharded and column-sharded scaling: correctness and time of the
``parallel/`` solves over worlds of 1, N/2 and N ranks.

The port's counterpart of ``experiments/experiment_scaling.py``.  A torch
world has one fixed size (JAX takes submeshes of ``devices()[:d]``), so
this starts one world per mesh size through ``parallel/launch.py``, each
rank running this module with ``--worker``.  In each world of d ranks:
``per_dev_batch * d`` problems solved batch-sharded in lock step
(``solve_box_qp_sharded``) and with each rank's own convergence test
(``solve_box_qp_shard_map``), each against the single-process solve of the
whole batch (|dx| < 1e-4).  In the world of N ranks, the tensor-parallel
section: one problem pair at n = max(n_x, 512) column-sharded over tp=N
(``solve_box_qp_tp``, |dx| < 1e-4), with its per-rank memory
(``lowered_tp_memory``) against tp=1's, taken in the one-rank world.

On one card several ranks share the device: pass ``--backend gloo``
(NCCL refuses two ranks on one device); gloo stages every collective
through the host, so the times are not NVLink times.  Writes no artifact.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_scaling \\
          [--nproc 2 --backend gloo] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from lqp_py_tpu_torch.experiments._common import gate
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

GATE = 1e-4


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=64)
    ap.add_argument("--per-dev-batch", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--nproc", type=int, default=None,
                    help="N, the largest world (default: the number of "
                         "cards, or 4 with --device cpu)")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend of the multi-rank "
                         "worlds (default: nccl with cards, gloo on the "
                         "CPU); 'gloo' for several ranks on one card")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each world may take, start-up included")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def world_sizes(n):
    return sorted({1, max(n // 2, 1), n})


def _worker(args):
    """One rank of a world: writes ``world<d>_rank<r>.json`` into
    ``args.worker``."""
    import torch.distributed as dist

    from lqp_py_tpu_torch import BoxQPConfig, solve_box_qp
    from lqp_py_tpu_torch.parallel import (initialize_distributed,
                                           lowered_tp_memory, make_mesh,
                                           shard_batch,
                                           solve_box_qp_shard_map,
                                           solve_box_qp_sharded,
                                           solve_box_qp_tp)
    from lqp_py_tpu_torch.utils.generators import create_qp_data

    initialize_distributed(backend=args.backend)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    d, rank = dist.get_world_size(), dist.get_rank()
    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol)

    B = args.per_dev_batch * d
    data = create_qp_data(args.n_x, B, seed=0, dtype=torch.float32,
                          device=dev)
    ref = solve_box_qp(*data, config=cfg)               # single-process
    ref_x = shard_batch(ref.x, mesh)
    s_g, t_g = clock(lambda: solve_box_qp_sharded(mesh, *data, config=cfg),
                     dev)
    s_m, t_m = clock(lambda: solve_box_qp_shard_map(mesh, *data,
                                                    config=cfg), dev)
    info = {"world": d, "rank": rank, "batch": B, "sharded_s": t_g,
            "shard_map_s": t_m,
            "err_sharded": float((s_g.x - ref_x).abs().max()),
            "err_shard_map": float((s_m.x - ref_x).abs().max()),
            "converged": int(s_g.converged.sum())}
    n_tp = max(args.n_x, 512)
    data_tp = create_qp_data(n_tp, 2, seed=0, dtype=torch.float32,
                             device=dev)
    if d == 1:
        info["tp1_temp_bytes"] = lowered_tp_memory(
            make_mesh((1, 1), ("dp", "tp")), *data_tp,
            config=cfg).temp_size_in_bytes
    if d == args.nproc:
        ref_tp = solve_box_qp(*data_tp, config=cfg)
        mesh_tp = make_mesh((1, d), ("dp", "tp"))
        s_tp, info["tp_s"] = clock(lambda: solve_box_qp_tp(
            mesh_tp, *data_tp, config=cfg), dev)
        info["n_tp"] = n_tp
        info["err_tp"] = float((s_tp.x - ref_tp.x).abs().max())
        info["tp_temp_bytes"] = lowered_tp_memory(
            mesh_tp, *data_tp, config=cfg).temp_size_in_bytes
    Path(args.worker, f"world{d}_rank{rank}.json").write_text(
        json.dumps(info))
    dist.destroy_process_group()


def run_world(d, args, tmp):
    """Launch a world of ``d`` ranks; ``[rank 0's record, ...]``.  A failed
    rank raises ``LaunchError`` with every rank's output."""
    from lqp_py_tpu_torch.parallel.launch import launch

    argv = [sys.executable, "-m", "lqp_py_tpu_torch.experiments."
            "experiment_scaling", "--worker", str(tmp), "--n-x",
            str(args.n_x), "--per-dev-batch", str(args.per_dev_batch),
            "--tol", repr(args.tol), "--nproc", str(args.nproc),
            "--device", args.device]
    if args.backend:
        argv += ["--backend", args.backend]
    launch(argv, d, timeout_s=args.timeout,
           cwd=str(Path(__file__).resolve().parents[2]))
    return [json.loads(Path(tmp, f"world{d}_rank{r}.json").read_text())
            for r in range(d)]


def main(argv=None):
    args = _args(argv)
    if args.worker:
        return _worker(args)
    dev = resolve_device(args.device)
    if args.nproc is None:
        args.nproc = torch.cuda.device_count() if dev.type == "cuda" else 4
    worlds = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in world_sizes(args.nproc):
            ranks = run_world(d, args, tmp)
            worlds[d] = ranks
            err_g = max(r["err_sharded"] for r in ranks)
            err_m = max(r["err_shard_map"] for r in ranks)
            print(f"devices={d} batch={ranks[0]['batch']}: lock-step "
                  f"{max(r['sharded_s'] for r in ranks):.3f}s "
                  f"(|dx|={err_g:.1e}) shard_map "
                  f"{max(r['shard_map_s'] for r in ranks):.3f}s "
                  f"(|dx|={err_m:.1e}) conv="
                  f"{sum(r['converged'] for r in ranks)}/{ranks[0]['batch']}",
                  flush=True)
            gate(err_g < GATE and err_m < GATE, "sharded != single-device")
    print("scaling OK: sharded solutions match single-device at every "
          "mesh size")
    top = worlds[args.nproc]
    err_tp = max(r["err_tp"] for r in top)
    m_tp = max(r["tp_temp_bytes"] for r in top)
    m_1 = worlds[1][0]["tp1_temp_bytes"]
    print(f"tp={args.nproc} n={top[0]['n_tp']}: solve "
          f"{max(r['tp_s'] for r in top):.3f}s |dx|={err_tp:.1e} per-rank "
          f"temp bytes {m_tp} vs unsharded {m_1} "
          f"({m_1 / max(m_tp, 1):.2f}x smaller)")
    gate(err_tp < GATE, "tp-sharded != single-device")
    return worlds


if __name__ == "__main__":
    main()
