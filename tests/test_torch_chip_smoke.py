"""chip_smoke.py rehearsed on the CPU at a tiny size.

The script's checks, counters and output lines run end to end with
``torch.cuda`` stubbed (events on the host clock) and each kernel wrapper
replaced by its plain version plus a launch count, so that a fault in the
script's own Python shows here and not first on the card.  Its numbers mean
nothing on the CPU; the gates that only the kernels can meet are left
out: the early-exit GEMV's 90%/0% time ratio and the block inverse's
exactly symmetric output (the plain version computes both triangles).
Phase 29, the drivers, has its own rehearsal
(tests/test_torch_chip_smoke_drivers.py).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _chip_smoke_stub import load_stubbed

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_rehearsal_on_cpu(monkeypatch, capsys):
    cs = load_stubbed(monkeypatch)
    check = cs._check
    monkeypatch.setattr(cs, "_check", lambda cond, msg: check(
        cond or "frozen panels are read" in msg or "not symmetric" in msg,
        msg))
    for name, value in (("N", 200), ("B", 8), ("N_PAD", 256), ("N_HARD", 2),
                        ("N_X2", 100), ("N_BATCH2", 16), ("MINI2", 4),
                        ("N_INEQ", 100), ("N_CONIC", 40), ("N_COND", 64),
                        ("DEVICE", "cpu")):
        monkeypatch.setattr(cs, name, value)
    # Phase 29 has its own rehearsal (tests/test_torch_chip_smoke_drivers.py).
    monkeypatch.setattr(cs, "_phase_29", lambda dev: {})

    cs.main()
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "rehearsal", "count": 1}}
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == [
        "sweep_spd_inverse", "gemv_early_exit", "block_spd_inverse"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert keys <= set(k), k["name"]
        assert k["launches"] > 0 and k["bound_by"] in ("bytes", "operations")
        assert (REPO / k["source"]).exists()
    assert {"ms_paced", "regs", "local_bytes"} <= set(kernels[0])
    assert {"ms_in_turns", "ratio_90_0", "turns_vs_call", "regs",
            "local_bytes"} <= set(kernels[1])
    assert {"turns_vs_recursion", "err_vs_f64", "plain_err_vs_f64", "regs",
            "local_bytes"} <= set(kernels[2])
    # The leaf counted on the paths of phases 12-15: the unrolled forward,
    # the polish (one factorization more than unpolished), none in the
    # Cholesky mode, the Anderson solve's factorizations.
    leaf = kernels[0]
    assert leaf["launches_unrolled"] == 2 and leaf["launches_cholesky"] == 0
    assert leaf["launches_polish"] >= 4 and leaf["launches_polish"] % 2 == 0
    assert leaf["launches_anderson"] >= 2
    # Phases 16-18: two leaves per n=200 factorization (init, iterations,
    # two polish rounds); in Schur mode two for Q^-1 and each polish round
    # and one per ni=100 block; the leaf's error on the IP operator.
    for key in ("launches_box_ip", "launches_optnet"):
        assert leaf[key] >= 2 * 4 and leaf[key] % 2 == 0, key
    assert leaf["launches_optnet_schur"] >= 2 + 2 + 4
    assert 0 < leaf["err_ip_vs_f64"] <= 2 * leaf["plain_err_ip_vs_f64"]
    # Phase 19: two leaves per n=200 factorization on the genqp forward
    # (direct and prepared requests), the polished solve (one more) and
    # the backward's solve.
    assert leaf["launches_genqp"] >= 2 * 2 and leaf["launches_genqp"] % 2 == 0
    assert leaf["launches_genqp_polish"] >= 2 * 2
    assert leaf["launches_genqp_bwd"] == 2
    assert kernels[1]["launches_big_batch"] == 1
    # Phases 22-23 (two gloo ranks, and a one-rank world, in worker
    # processes on the CPU): the leaf on the dp ranks' solves and on every
    # pivot panel of the tp=2 factorizations (two 100-wide panels, one a
    # rank, at n=200).
    assert leaf["launches_dp"] >= 2 * 2 and leaf["launches_dp"] % 2 == 0
    assert leaf["launches_tp"] >= 2
    assert leaf["launches_tp_per_rank"][0] == leaf["launches_tp_per_rank"][1]
    # Phases 24-26: one 100-wide panel a rank per factorization at n=200
    # (GenQP, the box IP), the early-exit step's rectangular GEMV once per
    # iteration on each rank.
    for key in ("genqp", "box_ip", "optnet_schur", "optnet_condensed"):
        ranks = leaf[f"launches_tp_{key}_per_rank"]
        assert ranks[0] == ranks[1] >= 1, key
    gemv = kernels[1]
    assert gemv["launches_tp"] == sum(gemv["launches_tp_per_rank"]) > 0
    assert {"ms_rect", "plain_ms_rect", "library_ms_rect",
            "bound_ms_rect"} <= set(gemv)
    # Phase 27: no leaf in the tp Cholesky mode; one factorization (a
    # 100-wide panel a rank) for OptNet without G.  Phase 28: four ranks,
    # one leaf per n_x=100 backward and the forward's factorizations, alike
    # within each dp shard; the dry run's factorizations too.
    assert leaf["launches_tp_cholesky_per_rank"] == [0, 0]
    assert leaf["launches_tp_optnet_eq_per_rank"] == [1, 1]
    train = leaf["launches_train_sharded_per_rank"]
    assert len(train) == 4 and min(train) >= 2 * 10
    assert train[0] == train[1] and train[2] == train[3]
    assert len(leaf["launches_dryrun_per_rank"]) == 4
    phases = {line.split()[1] for line in lines if line.startswith("phase")}
    assert phases == {str(i) for i in range(1, 29)}


def test_chip_smoke_without_cuda_fails_before_any_result(tmp_path):
    """Without a card the script exits non-zero and prints nothing; alone
    in a directory (no package beside it) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd in (REPO, tmp_path):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and res.stdout == "", cwd
