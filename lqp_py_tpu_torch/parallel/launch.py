"""Start the ranks of one ``torch.distributed`` world as subprocesses.

    python -m lqp_py_tpu_torch.parallel.launch --nproc 4 [--timeout 600] \\
        -- python worker.py [args ...]

Each rank runs the command with torchrun's variables (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port) and ``OMP_NUM_THREADS=1``, so that
several ranks on a few cores do not oversubscribe them.  A worker joins
with ``initialize_distributed()``.

``launch`` waits for every rank.  When one exits with an error, or the
time runs out, it kills the others and raises with every rank's output:
a missing peer cannot hang the caller.  The tests and ``chip_smoke.py``
start their worlds through it (subprocesses, not ``multiprocessing``, so
that it also runs inside a pytest-xdist worker).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence


class LaunchError(RuntimeError):
    """A rank failed or the world ran out of time; ``outputs`` holds each
    rank's combined stdout and stderr."""

    def __init__(self, message: str, outputs: Sequence[str]):
        super().__init__(message + "".join(
            f"\n--- rank {r} ---\n{out}" for r, out in enumerate(outputs)))
        self.outputs = list(outputs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], nproc: int, *, timeout_s: float,
           cwd: Optional[str] = None) -> list:
    """Run ``nproc`` ranks of ``argv``; return each rank's output (stdout
    and stderr together) once all have exited with 0."""
    port = _free_port()
    base = {**os.environ, "OMP_NUM_THREADS": "1",
            "WORLD_SIZE": str(nproc), "LOCAL_WORLD_SIZE": str(nproc),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(nproc)]
        procs = []
        try:
            for r in range(nproc):
                procs.append(subprocess.Popen(
                    list(argv), cwd=cwd, stdout=logs[r],
                    stderr=subprocess.STDOUT,
                    env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}))
            failure = _wait(procs, time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outputs = []
            for log in logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
    if failure:
        raise LaunchError(f"launch of {nproc} ranks of {list(argv)}: "
                          f"{failure}", outputs)
    return outputs


def _wait(procs, deadline) -> Optional[str]:
    """None once every process exited with 0; else what went wrong (the
    caller kills the rest)."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return f"rank {bad[0][0]} exited with {bad[0][1]}"
        if all(c == 0 for c in codes):
            return None
        if time.monotonic() > deadline:
            return "timed out"
        time.sleep(0.05)


def main(args=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is killed")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command [arguments]")
    ns = ap.parse_args(args)
    cmd = ns.cmd[1:] if ns.cmd[:1] == ["--"] else ns.cmd
    if not cmd:
        ap.error("no command given")
    try:
        outputs = launch(cmd, ns.nproc, timeout_s=ns.timeout)
    except LaunchError as e:
        print(e, file=sys.stderr)
        return 1
    for r, out in enumerate(outputs):
        print(f"--- rank {r} ---\n{out}", end="" if out.endswith("\n")
              else "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
