"""Profiling and timing helpers (counterpart of
``lqp_py_tpu.utils.profiling``).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace of everything inside into ``logdir``, the card's
  kernels included where there is a card.
- ``force(tree)``: wait for the devices of the tensors in a tree.
- ``clock(fn, device)``: one call's wall time, from an idle device to the
  end of its last kernel (``force``); the drivers' timed window.
- ``resolve_device(name)``: an entry point's ``--device``, raising where
  it names the card and there is none.
- ``timed(fn, *args)``: steady-state time of ``fn(*args)``, by CUDA events
  when ``fn`` returns tensors on the card, by the host clock otherwise.
- ``solve_stats(sol)``: a solution's iterations, residuals and convergence
  as a plain dict for logging.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import statistics
import time
from typing import Callable, Dict

import torch
from torch import nn


@contextlib.contextmanager
def trace(logdir):
    """Profile the block (every activity this build of torch supports: the
    card's kernels on a CUDA build) and write a Chrome trace into
    ``logdir``.  Yields the profiler, for ``key_averages()``."""
    prof = torch.profiler.profile()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        logdir = pathlib.Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(logdir / f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _tensors(tree):
    """The tensors in a tree of tensors, sequences, mappings, dataclasses
    and modules (parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _cuda_devices(tree):
    return sorted({t.device.index for t in _tensors(tree)
                   if t.device.type == "cuda"})


def force(tree):
    """Wait until every tensor in ``tree`` is computed: synchronize each
    card that holds one (CPU tensors are ready on return).  Reads nothing
    back."""
    for index in _cuda_devices(tree):
        torch.cuda.synchronize(index)
    return tree


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; a CUDA device without a card raises (there is
    no CPU fallback: pass ``--device cpu``)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the card "
                           "by default; pass --device cpu to run it on the "
                           "CPU")
    return dev


def clock(fn: Callable, device):
    """``(fn(), seconds)``: the host's wall time of one call of ``fn``, from
    an idle ``device`` to the end of its last kernel there (``force`` of a
    tensor on it, before and after)."""
    idle = torch.empty(0, device=device)
    force(idle)
    t0 = time.perf_counter()
    out = fn()
    force(idle)
    return out, time.perf_counter() - t0


def timed(fn: Callable, *args, n: int = 5, warmup: int = 1) -> Dict:
    """Median, min and max steady-state time of ``fn(*args)`` in seconds
    over ``n`` calls, after ``warmup`` calls (at least one).  Where the
    warm-up's result lies on a card, each call is timed by CUDA events on
    that card's current stream, from before the call to after its last
    kernel; otherwise by the host clock around the call."""
    for _ in range(max(warmup, 1)):
        out = force(fn(*args))
    devices = _cuda_devices(out)
    ts = []
    for _ in range(n):
        if devices:
            with torch.cuda.device(devices[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                force(out)
                end.synchronize()
                ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            force(fn(*args))
            ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "min_s": min(ts),
            "max_s": max(ts), "n": n}


def solve_stats(sol) -> Dict:
    """Iterations, converged share and the largest residuals of a
    ``BoxQPSolution`` or ``QPSolution`` (and the rho range where the
    solution has one)."""
    out = {
        "iterations": int(sol.iterations),
        "converged_frac": sol.converged.float().mean().item(),
        "max_primal_residual": sol.primal_residual.max().item(),
        "max_dual_residual": sol.dual_residual.max().item(),
    }
    if getattr(sol, "rho", None) is not None:
        out["rho_min"] = sol.rho.min().item()
        out["rho_max"] = sol.rho.max().item()
    return out
