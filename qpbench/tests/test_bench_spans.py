"""The span readers' arithmetic against hand counts, on a synthetic trace
with nested ``lqp.*`` spans."""

import json

import pytest

from qpbench import harness, spans, trace
from qpbench.metrics_common import idle_pct
from qpbench.tests.test_bench_yardstick import _Run, _synthetic


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"grid": [1, 1, 1]}}


def _with_spans(tmp_path):
    """A window of 200 us: scaling, a factorization, then a loop with two
    checks and a refactorization between them.  Busy 108 us; the idle gaps,
    by where the host was when each began:

    [0, 10) scale; [50, 55) loop; [70, 72) check; [80, 85) loop (the check
    ended at 80); [95, 110) the refactorization; [125, 130) and [140, 170)
    check; [180, 200) no span."""
    ev = [_span("qpbench.window", 0, 200),
          _span("lqp.scale", 0, 20),
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 2,
           "dur": 6},
          _span("lqp.factorize", 20, 20),
          _span("lqp.loop", 40, 120),
          _span("lqp.check", 60, 20),
          _span("lqp.factorize", 90, 10),
          _span("lqp.check", 120, 30)]
    for i, (ts, dur) in enumerate([(10, 40), (55, 15), (72, 8), (85, 10),
                                   (110, 15), (130, 10), (170, 10)]):
        ev.append(_kernel(f"k{i}", ts, dur))
    path = tmp_path / "spans.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.load_chrome(path, "qpbench.window")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_idle_charged_to_the_span_where_each_gap_began(tmp_path):
    tr = _with_spans(tmp_path)
    assert trace.busy_s(tr) == pytest.approx(108e-6)
    idle = spans.idle_s(tr)
    assert set(idle) == {"lqp.scale", "lqp.loop", "lqp.check",
                         "lqp.factorize"}
    assert idle["lqp.scale"] == pytest.approx(10e-6)
    assert idle["lqp.loop"] == pytest.approx(10e-6)
    assert idle["lqp.check"] == pytest.approx(37e-6)
    assert idle["lqp.factorize"] == pytest.approx(15e-6)
    # The gap that opens outside every span goes to none of them.
    assert sum(idle.values()) == pytest.approx(92e-6 - 20e-6)


@pytest.mark.parametrize("name,want", [
    ("loop_idle_ms.train", 1e3 * 10e-6 / 2),
    ("loop_idle_ms.serve", 1e3 * 10e-6 / 2),
    ("check_idle_ms.train", 1e3 * 37e-6 / 2),
    ("check_idle_ms.serve", 1e3 * 37e-6 / 2),
    ("refactors.serve", 0.5),
])
def test_readers_by_hand(tmp_path, name, want):
    run = _Run(_with_spans(tmp_path), records=[{}, {}])
    assert _read(name, run) == pytest.approx(want)


NEW = ["loop_idle_ms.train", "loop_idle_ms.serve", "check_idle_ms.train",
       "check_idle_ms.serve", "refactors.serve"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(tmp_path, name):
    assert _read(name, _Run(None, records=[{}])) is None
    # No lqp.* span: the parent program's trace.
    assert _read(name, _Run(_synthetic(tmp_path), records=[{}])) is None


def test_refactor_count_reads_zero_where_loops_hold_none(tmp_path):
    ev = [_span("qpbench.window", 0, 100), _span("lqp.factorize", 0, 10),
          _span("lqp.loop", 20, 60), _span("lqp.check", 30, 10),
          _kernel("k", 5, 20)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    run = _Run(trace.load_chrome(path, "qpbench.window"), records=[{}])
    assert _read("refactors.serve", run) == 0


def test_innermost_with_spans_of_two_threads():
    a = trace.Activity("lqp.loop", 0.0, 10.0)
    b = trace.Activity("lqp.factorize", 5.0, 10.0)   # another thread
    c = trace.Activity("lqp.check", 6.0, 1.0)
    got = spans.innermost([a, b, c], [12.0, 0.0, 6.5, 9.0, 7.0, 20.0])
    assert got == [b, a, c, b, b, None]


def test_launch_events_change_no_existing_reading(tmp_path):
    """The runtime's launch calls (``cuda_runtime``, ``cuda_driver``) with
    correlation ids leave every reading of the yardstick as it was."""
    base = _synthetic(tmp_path)
    raw = json.loads((tmp_path / "t.json").read_text())
    for i, e in enumerate(raw["traceEvents"]):
        if e["cat"] in ("kernel", "gpu_memcpy"):
            e.setdefault("args", {})["correlation"] = i
    raw["traceEvents"] += [
        {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": 1 + i,
         "dur": 1, "args": {"correlation": i}}
        for i, cat in enumerate(["cuda_runtime", "cuda_driver"] * 4)]
    path = tmp_path / "t2.json"
    path.write_text(json.dumps(raw))
    more = trace.load_chrome(path, "qpbench.window")
    assert trace.busy_s(more) == trace.busy_s(base)
    assert trace.gaps(more) == trace.gaps(base)
    assert trace.idle_by_host_op(more) == trace.idle_by_host_op(base)
    assert trace.top_device_ops(more) == trace.top_device_ops(base)
    assert idle_pct(_Run(more)) == idle_pct(_Run(base))
    leaf = harness.load_module("metrics", "leaf_roofline_pct.serve")
    assert leaf.read(_Run(more)) == leaf.read(_Run(base))
