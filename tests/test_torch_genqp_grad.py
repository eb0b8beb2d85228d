"""Parity of the general-inequality layer's gradients with the JAX package:
``qp_gen``'s autograd gradients of ``sum(w * x)`` with respect to all six
inputs against ``jax.vjp`` of the JAX ``qp_gen``, in the 'kkt' and 'conic'
backward modes, with and without equality rows, with p, b and h as (B, n)
and as (B, n, 1); the gradients the caller does not ask for are not built;
the conic mode's memory guard falls back to 'kkt' with a warning; an
unknown mode raises as the JAX package's does.

float64 on numpy-seeded data, forward at eps_abs = eps_rel = 1e-9: both
packages factor by Cholesky and solve the conic system by LU, so every
gradient matches to 1e-8, with one exception.  The 'kkt' backward on
general G solves ``H = Q + G' diag(lam/s) G`` with lam/s up to ~1e8 on the
active rows (s clamped at 1e-8), cond(H) ~5e9 here, and dense G keeps the
Jacobi equilibration from taming it (on the box ``G' diag(.) G`` is
diagonal).  The two packages form H with other rounding (an einsum
against a matmul), and fed the same residuals their gradients differ by
1.2e-7; those cases are held to the float64 rounding bound of the solve,
eps cond(H) times each gradient's largest entry.  The JAX gradients are
computed once per module.
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import genqp as jgen
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch.models import conic_grad as tconic
from lqp_py_tpu_torch.models import genqp as tgen
from lqp_py_tpu_torch.nn import GenQPModule

from test_torch_genqp import _box, _general

BASE = dict(eps_abs=1e-9, eps_rel=1e-9)
NAMES = ("dQ", "dp", "dA", "db", "dG", "dh")
# (data, equality rows, backward, layout of p/b/h)
CASES = {
    "kkt-box": ("box", True, "kkt", "squeezed"),
    "kkt-box-no-A-column": ("box", False, "kkt", "column"),
    "kkt-general-column": ("general", True, "kkt", "column"),
    "kkt-general-no-A": ("general", False, "kkt", "squeezed"),
    "conic-box-column": ("box", True, "conic", "column"),
    "conic-box-no-A": ("box", False, "conic", "squeezed"),
    "conic-general": ("general", True, "conic", "squeezed"),
    "conic-general-no-A-column": ("general", False, "conic", "column"),
}


def _data(name, with_A, layout):
    d = _box() if name == "box" else _general()
    if not with_A:
        d[2] = d[3] = None
    if layout == "column":
        for i in (1, 3, 5):
            d[i] = None if d[i] is None else d[i][..., None]
    return d


def _weights(d):
    return np.random.default_rng(7).standard_normal(d[1].shape)


@pytest.fixture(scope="module")
def jax_grads():
    """Each case's data and ``jax.vjp`` of the JAX ``qp_gen`` at
    ``w = N(0, 1)`` over the inputs that are given."""
    out = {}
    for case, (name, with_A, backward, layout) in CASES.items():
        d = _data(name, with_A, layout)
        cfg = J.GenQPConfig(backward=backward, **BASE)
        idx = [i for i, a in enumerate(d) if a is not None]

        def f(*given):
            args = [None] * 6
            for i, a in zip(idx, given):
                args[i] = a
            return jgen.qp_gen(*args, config=cfg)

        x, vjp = jax.vjp(f, *(jnp.asarray(d[i]) for i in idx))
        grads = [None] * 6
        for i, g in zip(idx, vjp(jnp.asarray(_weights(d)))):
            grads[i] = np.asarray(g)
        out[case] = (d, np.asarray(x), grads)
    return out


def _torch_grads(d, backward, want=(True,) * 6):
    """x and the gradients of the port's ``qp_gen`` (None where an input
    is absent or not asked for)."""
    ts = [None if a is None else torch.tensor(a).requires_grad_(w)
          for a, w in zip(d, want)]
    x = T.qp_gen(*ts, config=T.GenQPConfig(backward=backward, **BASE))
    (torch.tensor(_weights(d)) * x).sum().backward()
    return x.detach(), [None if t is None else t.grad for t in ts]


def _kkt_rounding_bound(d):
    """eps cond(H) for the 'kkt' backward's condensed operator at the
    port's solution."""
    Q, p, A, b, G, h = (None if a is None else torch.tensor(a) for a in d)
    sol = T.solve_qp_gen(Q, p, A, b, G, h, config=T.GenQPConfig(**BASE))
    w = torch.clamp(sol.lams, min=1e-8) / torch.clamp(sol.slacks, 1e-8, 1e12)
    H = Q + G.mT @ (w[..., None] * G)
    return torch.finfo(H.dtype).eps * torch.linalg.cond(H).max().item()


@pytest.mark.parametrize("case", list(CASES))
def test_qp_gen_gradients_match_jax_vjp(jax_grads, case):
    d, jx, jg = jax_grads[case]
    data, _, backward, _ = CASES[case]
    x, tg = _torch_grads(d, backward)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-8)
    rel = (_kkt_rounding_bound(d) if (data, backward) == ("general", "kkt")
           else 0.0)
    for name, t, j in zip(NAMES, tg, jg):
        if j is None:
            assert t is None, name
            continue
        assert t.shape == j.shape, name
        atol = max(1e-8, rel * np.abs(j).max())
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("backward", ["kkt", "conic"])
def test_gradients_not_asked_for_are_not_built(jax_grads, backward,
                                               monkeypatch):
    """With only p requiring grad, the backward is asked for no dQ, dA or
    dG and builds none; dp is the one of the full backward."""
    d = jax_grads[f"{backward}-general"
                  + ("-column" if backward == "kkt" else "")][0]
    full = _torch_grads(d, backward)[1]
    calls = []
    grads = tgen._genqp_grads

    def spy(*args, **kw):
        out = grads(*args, **kw)
        calls.append((kw["want_dQ"], kw["want_dA"], kw["want_dG"],
                      out[0], out[2], out[4]))
        return out

    monkeypatch.setattr(tgen, "_genqp_grads", spy)
    _, only_p = _torch_grads(d, backward,
                             want=(False, True, False, False, False, False))
    assert calls == [(False, False, False, None, None, None)]
    assert torch.equal(only_p[1], full[1])


def test_skipped_dG_leaves_the_other_gradients_unchanged():
    """``gen_qp_grad_kkt(want_dG=False)`` (``qp_int_grads``'s ``want_dG``)
    returns None for dG and the other five gradients bitwise."""
    Q, p, A, b, G, h = (torch.tensor(a) for a in _general())
    sol = T.solve_qp_gen(Q, p, A, b, G, h, config=T.GenQPConfig(**BASE))
    w = torch.tensor(_weights([Q, p]))
    args = (w, sol.x, sol.lams, sol.slacks, sol.nus, Q, A, G)
    full = tgen.gen_qp_grad_kkt(*args)
    no_dG = tgen.gen_qp_grad_kkt(*args, want_dG=False)
    assert full[4] is not None and no_dG[4] is None
    for name, a, b_ in zip(NAMES, full, no_dG):
        if name != "dG":
            assert torch.equal(a, b_), name


def test_conic_guard_falls_back_to_kkt(jax_grads, monkeypatch):
    """Above ``CONIC_BACKWARD_MAX_BYTES`` the conic mode warns and returns
    the 'kkt' gradients (the JAX package's guard,
    tests/test_genqp.py::test_conic_backward_guard_fires_at_flagship_shape);
    at the budget itself it runs."""
    d = jax_grads["conic-general"][0]
    Q, A, G = d[0], d[2], d[4]
    need = tconic.conic_backward_bytes(Q.shape[0], Q.shape[-1], A.shape[-2],
                                       G.shape[-2], 8)
    assert need == Q.shape[0] * (12 + 2 + 8) ** 2 * 8
    monkeypatch.setattr(tconic, "CONIC_BACKWARD_MAX_BYTES", need - 1)
    with pytest.warns(UserWarning, match="falling back to the condensed "
                      "'kkt' rule"):
        _, fell_back = _torch_grads(d, "conic")
    kkt = _torch_grads(d, "kkt")[1]
    for name, a, b_ in zip(NAMES, fell_back, kkt):
        assert torch.equal(a, b_), name
    monkeypatch.setattr(tconic, "CONIC_BACKWARD_MAX_BYTES", need)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, conic = _torch_grads(d, "conic")
    np.testing.assert_allclose(conic[0].numpy(),
                               jax_grads["conic-general"][2][0], rtol=0,
                               atol=1e-8)


def test_unknown_backward_raises_like_jax():
    d = _general()
    cfg = dict(backward="lu", **BASE)
    with pytest.raises(ValueError) as theirs:
        jax.grad(lambda p: jnp.sum(jgen.qp_gen(
            jnp.asarray(d[0]), p, *(jnp.asarray(a) for a in d[2:]),
            config=J.GenQPConfig(**cfg))))(jnp.asarray(d[1]))
    p = torch.tensor(d[1], requires_grad=True)
    x = GenQPModule(T.GenQPConfig(**cfg))(
        torch.tensor(d[0]), p, *(torch.tensor(a) for a in d[2:]))
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        x.sum().backward()
