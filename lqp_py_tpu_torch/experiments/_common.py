"""What every driver shares: the ``--device`` and ``--out-dir`` arguments,
the device's label in an artifact, the gates, the peak memory and the
artifact files.  The timed window and the device check are
``utils/profiling``'s ``clock`` and ``resolve_device``."""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
from pathlib import Path
from typing import Optional

import torch


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--out-dir", default=".",
                    help="where the artifacts go (default: the current "
                         "directory)")


@functools.cache
def device_label(dev: torch.device) -> str:
    """The artifact's ``device``: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, or ``"cpu"``."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def gate(cond, msg: str) -> None:
    """A driver's correctness gate: raises (under ``python -O`` too)."""
    if not cond:
        raise AssertionError(msg)


def memory_mark(dev: torch.device) -> Optional[int]:
    """Reset the card's peak-memory counter and return the bytes allocated
    now (None on the CPU), for ``peak_above``."""
    if torch.device(dev).type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return int(torch.cuda.memory_allocated(dev))


def peak_above(dev: torch.device, mark: Optional[int]) -> Optional[int]:
    """The card's peak allocation since ``memory_mark`` less what was
    allocated then: what the work in between added at most."""
    if mark is None:
        return None
    return int(torch.cuda.max_memory_allocated(dev)) - mark


def read_json(path) -> Optional[dict]:
    try:
        return json.loads(Path(path).read_text())
    except (FileNotFoundError, json.JSONDecodeError, ValueError):
        return None


def write_json(out_dir, name: str, payload) -> Path:
    path = Path(out_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))
    print(f"wrote {path}")
    return path
