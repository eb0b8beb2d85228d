"""Experiment 2: end-to-end learning through the QP layer.

The port's counterpart of ``experiments/experiment_2.py``, after the
reference learning benchmark (experiments/experiment_2.py: dz=500,
minibatch 32 of batch 128, 100 epochs, tol 1e-5, SGD lr=5e-4): a linear
model predicts the QP's cost vector p, the differentiable layer solves the
box QP, and the loss is the true QP objective at the layer output.

The data, features, ``beta_true`` and initial parameters are made once;
one warm-up step on the first ``mini_batch`` rows updates the parameters,
as the JAX driver's compile step does.  The minibatch indices come from
``np.random.RandomState(0)``, as in the JAX driver, so they are the same
indices.  Two paths train from the same parameters on the same data in
the same order: the per-step loop (one host read of the loss per step,
each step timed) and ``make_train_scan`` (the whole horizon, the losses
read once at the end; the JAX driver's fused ``lax.scan``).  Their loss
trajectories must agree to 1e-3 relative.

Writes ``exp2_results_torch.json`` into ``--out-dir``.

Run:  python -m lqp_py_tpu_torch.experiments.experiment_2 \\
          [--n-x 500 --epochs 100] [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lqp_py_tpu_torch import BoxQPConfig
from lqp_py_tpu_torch.experiments._common import (add_common_args,
                                                  device_label, gate,
                                                  write_json)
from lqp_py_tpu_torch.models.train import (LinearQP, init_params,
                                           make_train_scan, make_train_step)
from lqp_py_tpu_torch.ops.precision import highest_matmul_precision
from lqp_py_tpu_torch.utils.generators import create_qp_data
from lqp_py_tpu_torch.utils.profiling import clock, resolve_device

ARTIFACT = "exp2_results_torch.json"


def make_problem(n_x, n_features, n_batch, device, seed=0):
    """``(full, params)``: the training set ``(features, Q, p_true, A, b,
    lb, ub)`` with ``p_true = features @ beta_true`` (f32), and the initial
    ``LinearQP``, from the port's generator streams on ``device``."""
    data = create_qp_data(n_x, n_batch, seed=seed, dtype=torch.float32,
                          device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    features = torch.randn((n_batch, n_features), generator=g,
                           device=device)
    beta_true = torch.randn((n_features, n_x), generator=g, device=device)
    with highest_matmul_precision():
        p_true = features @ beta_true            # ground-truth linear cost
    params = init_params(n_features, n_x, generator=g, device=device)
    return (features, data.Q, p_true, data.A, data.b, data.lb,
            data.ub), params


def minibatch_indices(n_batch, mini_batch, epochs):
    """Every epoch's minibatch, drawn up front from
    ``np.random.RandomState(0)`` (the JAX driver's draws, in its order)."""
    rng = np.random.RandomState(0)
    return np.stack([rng.choice(n_batch, mini_batch, replace=False)
                     for _ in range(epochs)]).astype(np.int64)


def copy_params(params: LinearQP) -> LinearQP:
    return LinearQP(params.W.detach().clone(), params.bias.detach().clone())


def gather(full, idx):
    return tuple(None if v is None else v[idx] for v in full)


def warm_up(step, params, full, mini_batch):
    """The JAX driver's compile step: one SGD step on the first
    ``mini_batch`` rows (it updates ``params``)."""
    idx = torch.arange(mini_batch, device=full[0].device)
    params, loss = step(params, *gather(full, idx))
    return params, float(loss)


def run_loop(step, params, full, sel, device, log_every=10):
    """One step per row of ``sel``, each timed with its loss's host read;
    the minibatch is gathered outside the timed window.  Returns the
    parameters, the per-step losses and the summed time."""
    losses, t_total = [], 0.0
    for epoch, idx in enumerate(torch.as_tensor(sel, device=device)):
        mb = gather(full, idx)
        (params, loss), t = clock(lambda: step(params, *mb), device)
        losses.append(float(loss))
        t_total += t
        if log_every and epoch % log_every == 0:
            print(f"epoch {epoch:3d}  loss {losses[-1]:.5f}  "
                  f"cum time {t_total:.2f}s", flush=True)
    return params, losses, t_total


def run_fused(config, lr, params, full, sel, device):
    """The whole horizon through ``make_train_scan`` from a copy of
    ``params``, twice (the first run's time is the JAX driver's compile
    column): ``(losses, first_s, second_s)``."""
    run = make_train_scan(config, lr=lr)
    sel_t = torch.as_tensor(sel, device=device)
    times = []
    for _ in range(2):
        (_, losses), t = clock(lambda: run(copy_params(params), sel_t,
                                           *full), device)
        times.append(t)
    return losses.cpu().numpy(), times[0], times[1]


def loss_gate(losses_loop, losses_fused):
    """Same data, same update order: the trajectories agree to 1e-3
    relative (f32 reduction-order noise).  Returns the deviation."""
    dev = float(np.max(np.abs(np.asarray(losses_fused)
                              - np.asarray(losses_loop))))
    gate(dev < 1e-3 * max(1.0, abs(losses_loop[0])),
         f"fused vs per-step loss trajectories diverge: {dev:.3e}")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-x", type=int, default=500)
    ap.add_argument("--n-features", type=int, default=5)
    ap.add_argument("--n-batch", type=int, default=128)
    ap.add_argument("--mini-batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--tol", type=float, default=1e-5)
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    full, params = make_problem(args.n_x, args.n_features, args.n_batch,
                                device)
    cfg = BoxQPConfig(eps_abs=args.tol, eps_rel=args.tol)
    step = make_train_step(cfg, lr=args.lr)
    params, _ = warm_up(step, params, full, args.mini_batch)
    sel = minibatch_indices(args.n_batch, args.mini_batch, args.epochs)

    start = copy_params(params)
    _, losses, t_total = run_loop(step, params, full, sel, device)
    losses_fused, fused_first_s, fused_total_s = run_fused(
        cfg, args.lr, start, full, sel, device)
    dev = loss_gate(losses, losses_fused)

    print(f"total training time ({args.epochs} epochs): per-step "
          f"{t_total:.2f}s, whole horizon {fused_total_s:.2f}s (first run "
          f"{fused_first_s:.2f}s); loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(paths agree to {dev:.2e})")
    config = {k: v for k, v in vars(args).items() if k != "out_dir"}
    write_json(args.out_dir, ARTIFACT, {
        "device": device_label(device), "torch": torch.__version__,
        "total_time_s": t_total,
        "fused_total_s": fused_total_s,
        "fused_compile_s": fused_first_s,
        "fused_vs_loop_loss_dev": dev,
        "losses": losses,
        "config": config})
    return losses


if __name__ == "__main__":
    main()
