"""Load ``chip_smoke.py`` for a rehearsal on the CPU: ``torch.cuda``
stubbed (events on the host clock), the kernel build stubbed, and each
kernel wrapper replaced by its plain version plus a launch count."""

import importlib.util
import time
import types
from pathlib import Path

import torch

from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.ops.kernels import _build
from lqp_py_tpu_torch.ops.kernels import admm_step as gk
from lqp_py_tpu_torch.ops.kernels import block_inverse as bk
from lqp_py_tpu_torch.ops.kernels import mirror as mk
from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk

REPO = Path(__file__).resolve().parents[1]


class _HostEvent:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _counting(module, plain):
    def wrapper(*args, **kwargs):
        module.LAUNCHES += 1
        return plain(*args, **kwargs)
    return wrapper


def load_stubbed(monkeypatch):
    """The ``chip_smoke`` module, with the card and the kernels stubbed
    for the test's duration (``DEVICE`` still "cuda": set it)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    for name, value in (("is_available", lambda: True),
                        ("set_device", lambda d: None),
                        ("get_device_name", lambda i=0: "rehearsal"),
                        ("device_count", lambda: 1),
                        ("synchronize", lambda *a: None),
                        ("_sleep", lambda cycles: None),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("memory_allocated", lambda *a: 0),
                        ("max_memory_allocated", lambda *a: 1),
                        ("Event", _HostEvent)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(cs, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout="rehearsal, 0 W")))
    monkeypatch.setattr(_build, "load_library", lambda: None)
    monkeypatch.setattr(_build, "library_path", lambda: Path("stub.so"))
    monkeypatch.setattr(_build, "kernel_attributes",
                        lambda kernel: {"regs": 1, "local_bytes": 0})
    for mod in (sk, gk, bk, mk):
        monkeypatch.setattr(mod, "LAUNCHES", mod.LAUNCHES)
    leaf = _counting(sk, sk.sweep_spd_inverse_ref)
    monkeypatch.setattr(sk, "sweep_spd_inverse", leaf)
    monkeypatch.setattr(tlin, "sweep_spd_inverse", leaf)
    mirror = _counting(mk, mk.mirror_block_ref)
    monkeypatch.setattr(mk, "mirror_block", mirror)
    monkeypatch.setattr(tlin, "mirror_block", mirror)
    monkeypatch.setattr(gk, "gemv_early_exit",
                        _counting(gk, gk.gemv_early_exit_ref))
    monkeypatch.setattr(bk, "block_spd_inverse",
                        _counting(bk, bk.block_spd_inverse_ref))
    return cs
