"""chip_smoke.py's phase 29 (the port's experiment and demo drivers)
rehearsed on the CPU at a tiny size, with ``torch.cuda`` stubbed and each
kernel wrapper replaced by its plain version plus a launch count
(tests/_chip_smoke_stub.py), so that a fault in the phase's own Python
shows here and not first on the card.  Its numbers mean nothing here."""

import json

import torch

from _chip_smoke_stub import load_stubbed
from _torch_threads import one_torch_thread  # noqa: F401
from lqp_py_tpu_torch.cpu import native
from lqp_py_tpu_torch.experiments import experiment_1 as e1

TINY = {"exp1_n": 16, "native_n": 12, "serving_n": 16, "straggler_n": 16,
        "paper_n": 16, "hard_n": 16, "aa_n": 16, "aa_batch": 4, "ip_n": 24,
        "demo_n": 24, "layer_n": 24, "layer_batch": 4, "scaling_n": 16,
        "scaling_batch": 2}


def test_phase_29_rehearsal_on_cpu(monkeypatch, capsys, tmp_path):
    cs = load_stubbed(monkeypatch)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    native.load_library.cache_clear()
    for name, value in (("B", 4), ("N_HARD", 1), ("N_X2", 16),
                        ("N_BATCH2", 8), ("MINI2", 4), ("STEPS2", 3),
                        ("DEVICE", "cpu"), ("D29", TINY)):
        monkeypatch.setattr(cs, name, value)
    # Experiment 1's device_total: chains of two solves, not 64.
    monkeypatch.setattr(e1, "chain_length", lambda n_x: 2)
    try:
        launches = cs._phase_29(torch.device("cpu"))
    finally:
        native.load_library.cache_clear()
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("phase 29")]
    heads = ["Experiment 1 (", "Experiment 2", "serving", "straggler",
             "Experiment 1 paper", "Experiment 1 hard", "Anderson",
             "IP accuracy", "scaling", "demos", "README renderer",
             "drivers:"]
    assert [h for h in heads if not any(line.startswith(f"phase 29 {h}")
                                        for line in lines)] == []
    # Every f32 driver ran the leaf; the straggler's early-exit column ran
    # the GEMV; the float64 demos take Cholesky and run neither.
    for name in ("exp1", "exp2", "serving", "straggler", "exp1_paper",
                 "exp1_hard", "aa", "ip_accuracy", "demo_solve_box_qp",
                 "demo_box_qp_layer"):
        assert launches[name][0] > 0, name
    assert launches["straggler"][1] > 0
    assert launches["demo_polish"] == (0, 0)
    # The kernels line carries them (what main() adds to its JSON).
    assert json.dumps({k: v[0] for k, v in launches.items()})
    if native.available():
        assert "native" in launches
