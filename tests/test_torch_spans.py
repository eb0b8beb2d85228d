"""The solvers' spans (``utils/profiling.span``) under a CPU
``torch.profiler``: ``lqp.scale``, ``lqp.factorize``, ``lqp.loop``,
``lqp.check`` and OptNet's ``lqp.polish`` where the solvers enter them, one
``lqp.factorize`` per factorization (counted independently by wrapping the
SPD inverse and solve), every check inside a loop, the same bits with the
profiler on and off, and no ``record_function`` entered without a
profiler."""

import json

import pytest
import torch

import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import optnet as onet
from lqp_py_tpu_torch.ops import linalg as lin
from lqp_py_tpu_torch.ops import operator as op
from lqp_py_tpu_torch.utils.generators import create_qp_data
from lqp_py_tpu_torch.utils.profiling import span

from _torch_threads import one_torch_thread  # noqa: F401

# rho far below what the data asks for: adaptive rho refactorizes at least
# once in every loop below.
BOX = T.BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6, rho=1e-4)
GEN = T.GenQPConfig(eps_abs=1e-6, eps_rel=1e-6, rho=1e-4)
IP = T.OptNetConfig(tol=1e-6, max_iters=30, symmetrize=False)


def _data(dtype=torch.float64):
    return create_qp_data(24, 4, seed=1, dtype=dtype, device="cpu")


def _direct():
    d = _data()
    sol = T.solve_box_qp(*d, config=BOX)
    return (sol.x, sol.u, sol.rho)


def _prepared_warm():
    d = _data()
    prep = T.prepare_box_qp(d.Q, d.A, d.b, d.lb, d.ub, config=BOX)
    first = T.solve_box_qp_prepared(prep, d.p, config=BOX)
    p2 = d.p + 0.02 * torch.linspace(-1.0, 1.0, d.p.numel(),
                                     dtype=d.p.dtype).reshape(d.p.shape)
    sol = T.solve_box_qp_prepared(prep, p2, config=BOX, warm_start=first)
    return (first.x, sol.x, sol.u)


def _boxqp_fwdbwd():
    d = _data(torch.float32)
    Q, p = d.Q.clone().requires_grad_(True), d.p.clone().requires_grad_(True)
    x = T.boxqp(Q, p, d.A, d.b, d.lb, d.ub, config=BOX)
    dQ, dp = torch.autograd.grad(x.sum() + (x * x).sum(), (Q, p))
    return (x.detach(), dQ, dp)


def _qp_gen_fwdbwd():
    d = _data()
    G, h = d.with_G_h()
    Q, p = d.Q.clone().requires_grad_(True), d.p.clone().requires_grad_(True)
    x = T.qp_gen(Q, p, d.A, d.b, G, h, config=GEN)
    dQ, dp = torch.autograd.grad(x.sum() + (x * x).sum(), (Q, p))
    return (x.detach(), dQ, dp)


def _optnet_fwdbwd(G, h, d):
    Q, p = d.Q.clone().requires_grad_(True), d.p.clone().requires_grad_(True)
    x = T.qp_optnet(Q, p, d.A, d.b, G, h, config=IP)
    dQ, dp = torch.autograd.grad(x.sum() + (x * x).sum(), (Q, p))
    return (x.detach(), dQ, dp)


def _optnet_condensed_fwdbwd():
    """The box as G = [-I; I]: 'auto' takes the condensed factorization."""
    d = _data()
    return _optnet_fwdbwd(*d.with_G_h(), d)


def _optnet_schur_fwdbwd():
    """Eight general rows around a strictly feasible x = 0: 'auto' takes
    the Schur factorization (ni < n)."""
    d = _data()
    g = torch.Generator().manual_seed(3)
    G = torch.randn((4, 8, 24), generator=g, dtype=torch.float64)
    h = 0.5 + torch.rand((4, 8), generator=g, dtype=torch.float64)
    return _optnet_fwdbwd(G, h, d._replace(b=torch.zeros_like(d.b)))


# name -> (run, lqp.scale spans, lqp.loop spans, lqp.factorize spans
# outside every loop: the first factorization of each preparation, and the
# backward's; OptNet's two polish rounds, and in Schur mode Q's and the
# first Schur block's).
SCENARIOS = {
    "direct": (_direct, 1, 1, 1),
    "prepared_warm": (_prepared_warm, 1, 2, 1),
    "boxqp_fwdbwd": (_boxqp_fwdbwd, 1, 1, 2),
    "qp_gen_fwdbwd": (_qp_gen_fwdbwd, 1, 1, 2),
    "optnet_condensed_fwdbwd": (_optnet_condensed_fwdbwd, 0, 1, 4),
    "optnet_schur_fwdbwd": (_optnet_schur_fwdbwd, 0, 1, 5),
}
OPTNET = [name for name in SCENARIOS if name.startswith("optnet")]


def _profiled(run, tmp_path):
    """``(outputs, spans)``: ``spans`` the ``lqp.*`` ranges of the exported
    trace as ``(name, start_us, end_us)``, by start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("lqp.")]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


def _of(spans, name):
    return [s for s in spans if s[0] == name]


class _Count:
    """Calls of the SPD inverse and solve, wherever the solvers reach
    them: the factorizations counted without the spans.  OptNet's Schur
    mode inverts its d-dependent block through its own name of
    ``spd_inverse_fast``, so that block's function is counted; the m x m
    inverse of the equality rows' Schur complement rides with Q's, as
    every solver's does."""

    def __init__(self, monkeypatch):
        self.n = 0
        for mod, name in ((lin, "spd_inverse_fast"), (op, "spd_inverse_fast"),
                          (lin, "spd_solve_fast"),
                          (onet, "ip_factor_L22")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name)))

    def _wrap(self, fn):
        def counted(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        return counted


@pytest.mark.parametrize("name", SCENARIOS)
def test_spans_sit_where_the_work_is(name, tmp_path):
    run, n_scale, n_loop, n_outside = SCENARIOS[name]
    _, spans = _profiled(run, tmp_path)
    loops, checks = _of(spans, "lqp.loop"), _of(spans, "lqp.check")
    facts, scales = _of(spans, "lqp.factorize"), _of(spans, "lqp.scale")
    assert len(scales) == n_scale and len(loops) == n_loop
    assert checks
    for c in checks:
        assert any(_inside(c, lp) for lp in loops), c
    # Scaling holds no other span and runs before any loop.
    for s in scales:
        assert not any(_inside(o, s) for o in spans if o is not s)
        assert all(s[2] <= lp[1] for lp in loops)
    outside = [f for f in facts if not any(_inside(f, lp) for lp in loops)]
    assert len(outside) == n_outside
    # At least one adaptive-rho refactorization, inside a loop.
    assert len(facts) > n_outside


@pytest.mark.parametrize("name", OPTNET)
def test_optnet_polish_span_holds_its_two_rounds(name, tmp_path):
    _, spans = _profiled(SCENARIOS[name][0], tmp_path)
    (polish,) = _of(spans, "lqp.polish")
    (loop,) = _of(spans, "lqp.loop")
    assert loop[2] <= polish[1]
    inner = [s for s in spans if s is not polish and _inside(s, polish)]
    assert [s[0] for s in inner] == ["lqp.factorize"] * 2


@pytest.mark.parametrize("name", SCENARIOS)
def test_one_factorize_span_per_factorization(name, tmp_path, monkeypatch):
    count = _Count(monkeypatch)
    _, spans = _profiled(SCENARIOS[name][0], tmp_path)
    facts = _of(spans, "lqp.factorize")
    for i, a in enumerate(facts):
        for b in facts[i + 1:]:
            assert not (_inside(a, b) or _inside(b, a)), (a, b)
    assert count.n == len(facts) >= 2


@pytest.mark.parametrize("name", SCENARIOS)
def test_profiler_changes_no_bit(name, tmp_path):
    run = SCENARIOS[name][0]
    plain = run()
    traced, _ = _profiled(run, tmp_path)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SCENARIOS)
def test_no_record_function_without_a_profiler(name, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    SCENARIOS[name][0]()
    with pytest.raises(AssertionError):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with span("lqp.scale"):
                pass
