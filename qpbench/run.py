"""Run one cell of the benchmark once and print its result line.

    python3 qpbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (import, CUDA context, the port's kernels, data on the card from
the seed, one warm-up of every shape the traffic uses) is ``setup_s``.
With ``--trace 0`` the window then runs units of work back to back for
``--seconds``, each timed by the host clock from issue to the end of its
last kernel, and the end-to-end metrics are read.  With ``--trace 1`` the
traffic's ``trace_units`` units run under ``torch.profiler`` instead, and
the per-layer metrics are read from that trace.  Either way the answers the
timed path produced are then held against the plain reference
(``judge.py``), every unit has to have converged on every element, and the
last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    # Run as a script: import from the checkout's root, not from qpbench/.
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from qpbench import guard, harness, judge  # noqa: E402
from qpbench.roofline import F32_FLOPS, HBM_BYTES_S  # noqa: E402
from qpbench.trace import load_chrome  # noqa: E402

WINDOW = "qpbench.window"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """What the metric readers read: the cell, set-up time, the window's
    records (one dict per unit of work, with ``latency_s``), its length, and
    the trace of a traced run."""

    def __init__(self, cell):
        self.cell = cell
        self.setup_s = None
        self.records = []
        self.window_s = None
        self.trace = None


def _sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _timed_unit(work, device) -> dict:
    t0 = time.perf_counter()
    rec = work.unit()
    _sync(device)
    rec["latency_s"] = time.perf_counter() - t0
    for key, val in rec.items():
        if isinstance(val, (list, tuple)) and len(val) == 2:
            rec[key] = val[0].elapsed_time(val[1])   # CUDA events, ms
        elif hasattr(val, "item"):
            rec[key] = val.item()                    # a device scalar
    return rec


def window(work, device, seconds: float, run: Run) -> None:
    """Units back to back until ``seconds`` have passed."""
    t_start = time.perf_counter()
    while True:
        run.records.append(_timed_unit(work, device))
        elapsed = time.perf_counter() - t_start
        if elapsed >= seconds:
            break
    run.window_s = elapsed


def traced(work, device, units: int, run: Run) -> None:
    """``units`` units under the profiler; the trace is read back."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                t_start = time.perf_counter()
                for _ in range(units):
                    run.records.append(_timed_unit(work, device))
                run.window_s = time.perf_counter() - t_start
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        run.trace = load_chrome(path, WINDOW)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def metrics(run: Run, specs) -> dict:
    out = {}
    for spec in specs:
        value = harness.load_module("metrics", spec["name"]).read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None) -> dict:
    """Set-up, window (or traced units), judgement; returns the result
    object.  ``device`` is the card; the CPU only in the harness's tests."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell)
    pieces = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
    pieces["import_and_context_s"] = time.perf_counter() - t_start
    t = time.perf_counter()
    if device.type == "cuda":
        cell.solver.load_kernels()
    pieces["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    work = cell.kind.setup(cell, seed, device)
    _sync(device)
    pieces["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    work.warmup()
    _sync(device)
    pieces["warmup_s"] = time.perf_counter() - t
    run.setup_s = time.perf_counter() - t_start
    log("setup " + " ".join(f"{k} {v:.4f}" for k, v in pieces.items())
        + f" total {run.setup_s:.4f}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        traced(work, device, int(cell.traffic["trace_units"]), run)
    else:
        window(work, device, seconds, run)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window {run.window_s:.4f} s, {len(run.records)} units, "
        f"memory peak {peak} bytes")

    items = work.judged()
    work.release()
    del work
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reads = judge.readings(cell.reference, items,
                           float(cell.checks.get("margin", 0.0)))
    correct, rows = judge.verdict(reads, cell.checks)
    # The configuration's guarantee: every unit of the window converged on
    # every element.  An exact comparison, with the limit 0.
    failed = sum(int(r.get("failed", 1)) for r in run.records)
    correct = correct and failed == 0
    rows.append(("failed", failed, 0))
    log(f"reference {time.perf_counter() - t:.4f} s; readings "
        + json.dumps(reads))

    specs = cell.per_layer if trace else cell.end_to_end
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(run.records),
              "failed": failed,
              "metrics": metrics(run, specs), "device": dev}
    if trace:
        from qpbench import trace as tr
        dev["busy_s"] = tr.busy_s(run.trace)
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(run.trace),
                               "idle_gaps": tr.idle_by_host_op(run.trace)}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START)

    found = guard.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    log(f"{_power_limit()}; rooflines against {F32_FLOPS / 1e12:g} TFLOP/s "
        f"f32 and {HBM_BYTES_S / 1e12:g} TB/s")
    for name, check in result["checks"].items():
        log(f"check {name} {check['value']} limit {check['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
