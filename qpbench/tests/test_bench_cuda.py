"""One run of each cell on the card, through the command BENCHMARK.json
names (needs an NVIDIA GPU; skips elsewhere).  On the card:
``python3 -m pytest -m cuda qpbench/tests``."""

import json
import subprocess
import sys

import pytest

from qpbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, *harness.manifest()["command"][1:], "--workload",
         name, "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace",
         "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
