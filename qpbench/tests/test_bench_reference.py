"""The plain reference: its optimality on its own terms, its gradient
against finite differences, and the port against it at a tiny size on the
CPU."""

import pytest
import torch

from qpbench import data
from qpbench.reference import boxqp_ref as ref
from qpbench.tests import _tiny

SPEC = {"generator": "exp1", "n_x": 40, "n_eq": 1, "box": [1.0, 2.0],
        "dtype": "float32"}


@pytest.fixture(scope="module")
def problem():
    return data.make(SPEC, 8, data.generator(2 ** 32 + 5, "cpu"), "cpu")


def test_reference_is_optimal(problem):
    d = problem
    s = ref.solve(*d)
    assert bool(s.converged.all())
    Q, A = d.Q.double(), d.A.double()
    stat = ((Q @ s.x[..., None])[..., 0] + d.p.double() - s.zl + s.zu
            + (A.mT @ s.y[..., None])[..., 0])
    assert stat.abs().max() < 1e-9
    assert ((A @ s.x[..., None])[..., 0] - d.b.double()).abs().max() < 1e-12
    assert (s.x >= d.lb.double() - 1e-12).all()
    assert (s.x <= d.ub.double() + 1e-12).all()
    assert (s.zl >= 0).all() and (s.zu >= 0).all()
    assert (s.zl * s.sl).max() < 1e-9 and (s.zu * s.su).max() < 1e-9


def test_reference_gradient_matches_finite_differences(problem):
    d = problem
    s = ref.solve(*d)
    w = torch.randn(d.p.shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    v = ref.grad_p(d.Q, d.A, s, w)
    eps = 1e-6
    for i in (0, 7, 23):
        e = torch.zeros_like(v)
        e[:, i] = eps
        hi = ref.solve(d.Q, d.p.double() + e, d.A, d.b, d.lb, d.ub).x
        lo = ref.solve(d.Q, d.p.double() - e, d.A, d.b, d.lb, d.ub).x
        fd = ((w * hi).sum(-1) - (w * lo).sum(-1)) / (2 * eps)
        assert (fd - v[:, i]).abs().max() < 1e-5
    # dL/dQ of a symmetric-use Q: 0.5 (v x' + x v').
    dQ = ref.grad_q(v, s.x)
    assert torch.allclose(dQ, dQ.mT)


def test_tf32_round_by_hand():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9, 0.0])
    got = ref.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -3.0 - 2 ** -9, 0.0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["exp1-fwdbwd", "genqp-fwdbwd"])
def test_port_against_reference_tiny(name):
    """The port's fwd+bwd at a tiny size, on the CPU, within its limits."""
    r = _tiny.run(name)
    assert r["correct"], r["checks"]
    assert r["checks"]["x_err"]["value"] < 1e-3


def test_train_loss_gives_nonzero_dp():
    """sum(w * x) moves x off the sum-to-one row; sum(x) cannot."""
    from qpbench.kinds import train_step
    cell = _tiny.cell("exp1-fwdbwd")
    work = train_step.setup(cell, _tiny.SEED, torch.device("cpu"))
    work.unit()
    x, dp, dQ = work.last[0]
    assert dp.abs().amax(-1).min() > 1e-3
    d = work.pool[0]
    x, _ = cell.solver.layer(d, work.opts)
    dp_sum, = torch.autograd.grad(x.sum(), (d.p,))
    assert dp_sum.abs().max() < 1e-4 * dp.abs().max()
