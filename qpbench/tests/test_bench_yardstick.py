"""The yardstick's arithmetic against hand counts, on a synthetic trace."""

import json

import pytest

from qpbench import harness, roofline, trace
from qpbench.metrics_common import idle_pct


def test_leaf_bytes_and_bound_by_hand():
    # (512, 128, 128) float32 read once and written once.
    assert roofline.leaf_bytes(512) == 2 * 512 * 128 * 128 * 4 == 67108864
    assert roofline.leaf_flops(512) == 512 * 128 ** 3
    b = roofline.bound_s(roofline.leaf_flops(128), roofline.leaf_bytes(128))
    assert b == pytest.approx(16777216 / 3.35e12)      # 5.0 us, by bytes
    assert roofline.leaf_flops(128) / roofline.F32_FLOPS < b


def test_gemv_bytes_by_hand():
    # P (512, 1000, 1000), r and out (512, 1000), float32, all active.
    assert roofline.gemv_bytes(512, 512, 1000, 1000) == 4 * 512 * (
        1000 * 1000 + 1000 + 1000)
    # Frozen elements read their x_prev instead of P and r.
    assert roofline.gemv_bytes(4, 1, 10, 10) == 4 * (110 + 3 * 10 + 4 * 10)
    assert roofline.gemv_flops(512, 1000, 1000) == 2 * 512 * 10 ** 6


def test_union_of_overlapping_intervals():
    got = trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)], 0, 10)
    assert got == [(0, 3), (5, 6), (8, 10)]
    assert trace.union([(-1, 0.5), (3, 2)], 0, 1) == [(0, 0.5)]


def _synthetic(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "qpbench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 60,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void sweep_kernel<true>",
         "ts": 10, "dur": 20, "args": {"grid": [512, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "gemv2T_kernel", "ts": 25,
         "dur": 15, "args": {"grid": [8, 512, 1]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 98, "dur": 10,
         "args": {"grid": [1, 1, 1]}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.load_chrome(path, "qpbench.window")


class _Run:
    def __init__(self, tr, cell=None, records=()):
        self.trace, self.cell, self.records = tr, cell, list(records)


def test_idle_and_breakdown_on_a_synthetic_trace(tmp_path):
    tr = _synthetic(tmp_path)
    assert tr.window_s == pytest.approx(100e-6)
    # Busy: [10, 40] + [90, 95] + [98, 100] = 37 of 100 us.
    assert trace.busy_s(tr) == pytest.approx(37e-6)
    assert idle_pct(_Run(tr)) == pytest.approx(63.0)
    assert [tuple(round(x * 1e6, 6) for x in g) for g in trace.gaps(tr)] == [
        (0, 10), (40, 90), (95, 98)]
    idle = dict(trace.idle_by_host_op(tr))
    assert idle["aten::mm"] == pytest.approx(10e-6)
    assert idle["aten::add"] == pytest.approx(50e-6)
    assert idle["host idle"] == pytest.approx(3e-6)
    top = trace.top_device_ops(tr)
    assert top[0] == ["void sweep_kernel<true>", pytest.approx(20e-6)]


def test_roofline_readers_on_a_synthetic_trace(tmp_path):
    tr = _synthetic(tmp_path)
    leaf = harness.load_module("metrics", "leaf_roofline_pct.serve")
    want = 100 * roofline.leaf_bytes(512) / roofline.HBM_BYTES_S / 20e-6
    assert leaf.read(_Run(tr)) == pytest.approx(want)
    cell = harness.Cell("exp1-serve-warm")
    cell.traffic["batch"], cell.config["problem"]["n_x"] = 4, 10
    gemv = harness.load_module("metrics", "gemv_roofline_pct.serve")
    want = 100 * 3 * roofline.gemv_bytes(4, 4, 10, 10) / 3.35e12 / 15e-6
    got = gemv.read(_Run(tr, cell, [{"iterations": 1}, {"iterations": 2}]))
    assert got == pytest.approx(want)
    # Nothing to read: no result, never 0.
    assert leaf.read(_Run(None)) is None
    assert gemv.read(_Run(tr, cell, [])) is None
