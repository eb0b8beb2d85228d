"""The readings that the limits of ``checks/<workload>.json`` are set from.

    python3 qpbench/control.py --workload NAME --seeds S [S ...]
        [--control-seeds S [S ...]] [--seconds 2] [--out FILE]

For each seed, in one process on the card: the cell's set-up, a short
window of its timed path, and the judge's numbers for the answers it
produced (the program's readings).  For each control seed, the same
answers are made again by the control, the plain reference put in the
program's place and computed one precision below the configuration's:
float32 with every matrix operand rounded to TF32 (``tf32=True``).  A
limit lies above every program reading and below every control reading.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from qpbench import harness, judge  # noqa: E402
from qpbench import run as R  # noqa: E402


def control_items(ref, items, block: int = 64):
    """The judged answers, made by the reference in TF32 instead."""
    import torch
    out = []
    for it in items:
        xs, dps = [], []
        for i in range(0, it.x.shape[0], block):
            d = it.problem.rows(slice(i, i + block))
            s = ref.solve(*d, tf32=True)
            xs.append(s.x.float())
            if it.dp is not None:
                dps.append(ref.grad_p(d.Q, d.A, s, it.w[i:i + block],
                                      tf32=True).float())
        x = torch.cat(xs)
        if it.dp is None:
            out.append(judge.Judged(it.problem, x))
        else:
            dp = torch.cat(dps)
            out.append(judge.Judged(it.problem, x, dp, ref.grad_q(dp, x),
                                    it.w))
    return out


def readings(cell, seed, seconds, device, control: bool) -> dict:
    """Set-up, a window of ``seconds``, and the program's readings (and
    the control's on the same inputs)."""
    import torch
    work = cell.kind.setup(cell, seed, device)
    work.warmup()
    run = R.Run(cell)
    R.window(work, device, seconds, run)
    items = work.judged()
    work.release()
    del work
    if device.type == "cuda":
        torch.cuda.empty_cache()
    margin = float(cell.checks.get("margin", 0.0))
    out = {"seed": seed, "units": len(run.records),
           "failed": sum(int(r.get("failed", 1)) for r in run.records),
           "program": judge.readings(cell.reference, items, margin)}
    if control:
        out["control"] = judge.readings(
            cell.reference, control_items(cell.reference, items), margin)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = harness.Cell(args.workload)
    cell.solver.load_kernels()
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t = time.perf_counter()
        row = readings(cell, seed, args.seconds, device,
                       seed in args.control_seeds)
        row["s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
