"""The interior points with the box as constraints against the benchmark's
plain reference (``qpbench/reference/boxqp_ref.py``: a float64 Mehrotra
interior point by Cholesky that shares no code with the port).

- OptNet with G = [-I; I], h = [-lb; ub] on ``create_qp_data`` problems at
  B=4, n=64: x in float64 within 1e-6, and dp, dQ of the loss sum(w x)
  within 1e-5 relative per element on the elements whose active set the
  problem determines (the reference's ``margin`` at least 1e-4); in float32
  with the polish, x within 1e-4.  At Experiment 1's tol 1e-5, in both
  precisions, dp and dQ within 1e-4 relative: the backward differentiates
  the polished point.
- The float32 polish at n=1000, where the rounding of the sum-to-one row's
  residual (~1e-4) exceeds the acceptance threshold tol (1 + |h|) = 3e-5:
  OptNet and the box IP leave every element within 1e-4 of the float64
  optimum.  A polish rejected for that rounding keeps the interior point's
  x, ~3e-3 away on this data.
- The third polish round, run only where round 2 narrowly failed on some
  element: with both rounds made to fail narrowly on one element, a third
  runs and gives that element the answer the second would have, and the
  element keeps the interior point's x if the third fails too; with every
  element passing, or after a wide miss, none runs; in both precisions.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import box_ip, optnet
from lqp_py_tpu_torch.utils.generators import create_qp_data

from _torch_threads import one_torch_thread  # noqa: F401

REF_PATH = (Path(__file__).resolve().parents[1] / "qpbench" / "reference"
            / "boxqp_ref.py")


def _load_ref():
    """The reference module, loaded by path as ``qpbench/harness.py`` loads
    modules (it imports nothing but torch)."""
    key = "qpbench.reference.boxqp_ref"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


ref = _load_ref()
CFG = T.OptNetConfig(tol=1e-10, max_iters=60, symmetrize=False)
# Experiment 1's interior-point configuration (experiment_1.py ip_config).
CFG_EXP1 = T.OptNetConfig(tol=1e-5, max_iters=30, symmetrize=False)


def _data(n, B, seed, dtype):
    return create_qp_data(n, B, seed=seed, dtype=dtype, device="cpu")


def _ref_solve(d):
    return ref.solve(*(t.double() for t in d[:6]))


def _optnet(d, config, grad=False):
    G, h = d.with_G_h()
    Q, p = d.Q.clone(), d.p.clone()
    if grad:
        Q.requires_grad_(True)
        p.requires_grad_(True)
    return T.qp_optnet(Q, p, d.A, d.b, G, h, config=config), Q, p


def test_optnet_box_float64_x_and_gradients_match_the_reference():
    d = _data(64, 4, 3, torch.float64)
    sol = _ref_solve(d)
    assert bool(sol.converged.all())
    x, Q, p = _optnet(d, CFG, grad=True)
    assert (x.detach() - sol.x).abs().max().item() <= 1e-6
    w = torch.randn(d.p.shape, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    dQ, dp = torch.autograd.grad((w * x).sum(), (Q, p))
    keep = ref.margin(sol) >= 1e-4
    assert int(keep.sum()) >= 2
    v = ref.grad_p(d.Q, d.A, sol, w)
    dQ_ref = ref.grad_q(v, sol.x)
    for got, want in ((dp, v), (dQ, dQ_ref)):
        err = ((got - want).abs().flatten(1).amax(-1)
               / want.abs().flatten(1).amax(-1))
        assert err[keep].max().item() <= 1e-5, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_layer_gradients_at_experiment_1_tolerance_match_the_reference(
        dtype):
    """At tol 1e-5 the backward differentiates the polished point, with the
    accepted polish's multipliers: 0 on the rows it left free.  The IP's
    own z there, as the JAX package's layer takes them, read d = z/s of
    order one on free coordinates near a bound, and the gradient 3e-2 to
    1.2e-1 off on this data (1e-2 to 3e-2 in float64)."""
    d = _data(64, 4, 3, dtype)
    sol = _ref_solve(d)
    x, Q, p = _optnet(d, CFG_EXP1, grad=True)
    w = torch.randn(d.p.shape, generator=torch.Generator().manual_seed(3),
                    dtype=dtype)
    dQ, dp = torch.autograd.grad((w * x).sum(), (Q, p))
    keep = ref.margin(sol) >= 1e-4
    assert int(keep.sum()) >= 2
    v = ref.grad_p(d.Q.double(), d.A.double(), sol, w.double())
    for got, want in ((dp, v), (dQ, ref.grad_q(v, sol.x))):
        err = ((got.double() - want).abs().flatten(1).amax(-1)
               / want.abs().flatten(1).amax(-1))
        assert err[keep].max().item() <= 1e-4, err


def test_optnet_box_float32_polished_x_matches_the_reference():
    d = _data(64, 4, 3, torch.float32)
    sol = _ref_solve(d)
    x, _, _ = _optnet(d, CFG_EXP1)
    assert (x.double() - sol.x).abs().max().item() <= 1e-4


@pytest.mark.parametrize("solver", ["optnet", "box_ip"])
def test_float32_polish_at_n1000_is_accepted_on_every_element(solver):
    d = _data(1000, 2, 1, torch.float32)
    sol = _ref_solve(d)
    if solver == "optnet":
        x, _, _ = _optnet(d, CFG_EXP1)
    else:
        x = T.solve_box_qp_ip(*d[:6], config=CFG_EXP1).x
    err = (x.double() - sol.x).abs().amax(-1)
    assert err.max().item() <= 1e-4, err


def _solver(name, d):
    if name == "optnet":
        return lambda: _optnet(d, CFG_EXP1)[0]
    return lambda: T.solve_box_qp_ip(*d[:6], config=CFG_EXP1).x


POLISH = {"optnet": (optnet, "gen_penalty_polish"),
          "box_ip": (box_ip, "box_penalty_polish")}


def _spoiled(real, spoil_first, lam):
    """The penalty polish, its first ``spoil_first`` rounds given the
    multiplier ``lam`` on a row of the last element that the round did not
    pin (the sign test then fails; the repair, which reads only pinned
    rows' multipliers and violated rows, is the same); its calls."""
    calls = []

    def polish(*args, **kw):
        out = real(*args, **kw)
        calls.append(1)
        if len(calls) > spoil_first:
            return out
        key = "lam" if "act" in kw else "lam_lo"
        free = torch.nonzero(~kw["act" if "act" in kw else "act_lo"][-1])
        spoilt = getattr(out, key).clone()
        spoilt[-1, free[0, 0]] = lam
        return out._replace(**{key: spoilt})
    return polish, calls


# A multiplier beyond the sign test's threshold, within ten times it: a
# narrow miss.  The thresholds: OptNet's in float32 4.8e-4 (the AL noise
# floor), else tol (1 + |h|) = 3e-5; the box IP's tol (1 + |bounds|) <= 3e-5.
NARROW = {("optnet", torch.float32): -1e-3, ("optnet", torch.float64): -1e-4,
          ("box_ip", torch.float32): -1e-4, ("box_ip", torch.float64): -1e-4}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("solver", ["optnet", "box_ip"])
def test_third_round_only_after_a_narrow_miss(solver, dtype, monkeypatch):
    """In float64 too: the port's polish there differs from the JAX
    package's wherever the third round runs."""
    d = _data(64, 4, 3, dtype)
    solve = _solver(solver, d)
    module, name = POLISH[solver]
    real = getattr(module, name)
    want = solve()
    raw = (_optnet(d, dataclasses.replace(CFG_EXP1, polish=False))[0]
           if solver == "optnet" else T.solve_box_qp_ip(
               *d[:6], config=dataclasses.replace(CFG_EXP1, polish=False)).x)
    narrow = NARROW[solver, dtype]
    for spoil, lam, calls_want, last in (
            (0, narrow, 2, want),    # every element passes round 2
            (2, narrow, 3, want),    # round 3 repeats round 2's guess
            (3, narrow, 3, raw),     # refused in every round
            (2, -1.0, 2, raw)):      # a wide miss: no third round
        polish, calls = _spoiled(real, spoil, lam)
        monkeypatch.setattr(module, name, polish)
        got = solve()
        assert len(calls) == calls_want, (spoil, lam)
        assert torch.equal(got[:-1], want[:-1])
        if spoil == 2 and lam == narrow:
            # Round 3 solves that element alone, which rounds apart from
            # the whole batch's solve (1.2e-6 here in float32); the IP's x
            # lies 6e-5 (OptNet) and 1.8e-3 (box IP) away.
            torch.testing.assert_close(got[-1], want[-1], rtol=0, atol=1e-5)
        else:
            assert torch.equal(got[-1], last[-1]), (spoil, lam)
