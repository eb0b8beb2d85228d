"""The control, the plain reference in TF32 put in the program's place,
comes out not correct under each cell's limits (at a tiny size on the
CPU; control.py reads it on the card at the cells' own sizes)."""

import pytest
import torch

from qpbench import judge
from qpbench.control import control_items
from qpbench.tests import _tiny


@pytest.mark.parametrize("name", ["exp1-fwdbwd", "genqp-fwdbwd",
                                  "exp1-serve-warm", "exp1-serve-cold"])
def test_control_fails_a_limit(name):
    torch.set_num_threads(2)
    cell = _tiny.cell(name)
    # At n=48 the control's error in x is ~1e-3 (fewer terms per product);
    # at n=256 it is ~3e-3, as at the cells' own n.
    cell.config["problem"]["n_x"] = 256
    cell.traffic["batch"] = 4
    work = cell.kind.setup(cell, _tiny.SEED, torch.device("cpu"))
    work.warmup()
    work.unit()
    items = work.judged()
    margin = float(cell.checks.get("margin", 0.0))
    ctrl = judge.readings(cell.reference, control_items(cell.reference,
                                                         items), margin)
    correct, rows = judge.verdict(ctrl, cell.checks)
    assert not correct, rows
