"""Parity of the port's linear algebra (lqp_py_tpu_torch.ops.linalg and
the SWEEP leaf's plain version) with the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX sweep leaf runs in Pallas interpret mode, as tests/test_linalg.py runs
it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lqp_py_tpu.ops import linalg as jlin
from lqp_py_tpu.ops.pallas import spd_inverse as jsw
from lqp_py_tpu_torch.ops import linalg as tlin
from lqp_py_tpu_torch.ops.kernels.spd_inverse import sweep_spd_inverse_ref


def _spd(seed, b, n, dtype=np.float64):
    """SPD stack as tests/test_linalg.py makes it: 0.01 a'a + I."""
    a = np.random.default_rng(seed).standard_normal((b, n, n)) * 0.1
    return (np.einsum("bki,bkj->bij", a, a) + np.eye(n)).astype(dtype)


def _wishart(seed, b, n, shift=0.5):
    L = np.random.default_rng(seed).standard_normal((b, 2 * n, n))
    return np.einsum("bsi,bsj->bij", L, L) / (2 * n) + shift * np.eye(n)


def test_sweep_leaf_plain_matches_jax_and_numpy():
    # The bounds of tests/test_linalg.py's leaf test (f32 sweep vs f64).
    H = _spd(0, 4, 128, np.float32)
    ours = sweep_spd_inverse_ref(torch.from_numpy(H)).numpy()
    theirs = np.asarray(jsw.sweep_spd_inverse(jnp.asarray(H),
                                              interpret=True))
    ref = np.linalg.inv(H.astype(np.float64))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-5)


def test_sweep_leaf_plain_float64_is_exact_to_roundoff():
    H = _spd(1, 3, 128)
    ours = sweep_spd_inverse_ref(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(ours, np.linalg.inv(H), rtol=1e-11,
                               atol=1e-13)


def test_schur_inverse_matches_jax_recursion():
    # n=200 padded to 256 with an identity block: two 128 leaves.
    n, n_pad = 200, 256
    H = _spd(2, 2, n, np.float32)
    Hp = np.zeros((2, n_pad, n_pad), np.float32)
    Hp[:, :n, :n] = H
    Hp[:, n:, n:] = np.eye(n_pad - n, dtype=np.float32)

    ours = tlin._schur_inverse(torch.from_numpy(Hp))[:, :n, :n].numpy()

    import functools
    ee = functools.partial(jnp.einsum, precision="highest")
    orig = jsw.sweep_spd_inverse
    jsw.sweep_spd_inverse = lambda X, **kw: orig(X, interpret=True)
    try:
        theirs = np.asarray(jlin._schur_inverse(jnp.asarray(Hp), ee))
    finally:
        jsw.sweep_spd_inverse = orig
    theirs = theirs[:, :n, :n]

    ref = np.linalg.inv(H.astype(np.float64))
    np.testing.assert_allclose(ours, ref, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ours, theirs, rtol=5e-4, atol=5e-5)


def test_schur_inverse_on_a_strided_view_matches_jax_recursion():
    """The recursion on a leading-block view of a larger stack (its
    leaves get views, read in place by the card's kernel) equals the
    recursion on the contiguous input, and the JAX recursion."""
    n = 256
    H = _spd(12, 2, n, np.float32)
    big = np.zeros((2, n + 128, n + 128), np.float32)
    big[:, :n, :n] = H
    view = torch.from_numpy(big)[:, :n, :n]
    assert not view.is_contiguous()

    ours = tlin._schur_inverse(view)
    assert torch.equal(ours, tlin._schur_inverse(torch.from_numpy(H)))

    import functools
    ee = functools.partial(jnp.einsum, precision="highest")
    orig = jsw.sweep_spd_inverse
    jsw.sweep_spd_inverse = lambda X, **kw: orig(X, interpret=True)
    try:
        theirs = np.asarray(jlin._schur_inverse(jnp.asarray(H), ee))
    finally:
        jsw.sweep_spd_inverse = orig
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(ours.numpy(), np.linalg.inv(
        H.astype(np.float64)), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("n,dtype,equilibrate,rtol", [
    (40, torch.float32, True, 2e-4),     # batch-major Gauss-Jordan
    (200, torch.float32, True, 5e-4),    # padded recursion + sweep leaves
    (256, torch.float32, False, 5e-4),   # recursion, no padding
    (200, torch.float64, True, 1e-10),   # Cholesky
])
def test_spd_inverse_fast_dispatch(n, dtype, equilibrate, rtol, monkeypatch):
    leaf_calls = []
    orig = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaf_calls.append(X.shape)
                        or orig(X, **kw))
    H = _wishart(3, 3, n)
    Hi = tlin.spd_inverse_fast(torch.tensor(H, dtype=dtype),
                               equilibrate=equilibrate)
    assert Hi.dtype == dtype
    np.testing.assert_allclose(Hi.double().numpy(), np.linalg.inv(H),
                               rtol=rtol, atol=rtol / 10)
    # float32 above 64 goes through the 128x128 leaves; nothing else does.
    expect = (n // 128 + (n % 128 > 0)) if (dtype == torch.float32
                                            and n > 64) else 0
    assert len(leaf_calls) == expect
    assert all(s[1:] == (128, 128) for s in leaf_calls)


@pytest.mark.parametrize("n,B,seed", [(4, 3, 0), (10, 16, 1), (64, 5, 2)])
def test_gj_inverse_small_matches_jax(n, B, seed):
    H = _wishart(seed, B, n)
    ours = tlin._gj_inverse_small(torch.from_numpy(H)).numpy()
    theirs = np.asarray(jlin._gj_inverse_small(jnp.asarray(H)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ours, np.linalg.inv(H), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("with_eq", [True, False])
def test_factorize_kkt_and_apply_match_jax(with_eq):
    B, n, m = 3, 40, 5
    rng = np.random.default_rng(4)
    Q = _spd(5, B, n)
    A = rng.standard_normal((B, m, n)) if with_eq else None
    rho = np.linspace(0.5, 2.0, B)
    r = rng.standard_normal((B, n))
    b = rng.standard_normal((B, m)) if with_eq else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731

    f_t = tlin.factorize_kkt(t(Q), t(rho), t(A))
    f_j = jlin.factorize_kkt(j(Q), j(rho), j(A), mode="inverse")
    x_t, nu_t = tlin.kkt_apply(f_t, t(r), t(b))
    x_j, nu_j = jlin.kkt_apply(f_j, j(r), j(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j),
                               rtol=1e-9, atol=1e-11)
    _, q_t = tlin.kkt_step_operator(f_t, t(b))
    _, q_j = jlin.kkt_step_operator(f_j, j(b))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j),
                               rtol=1e-9, atol=1e-11)
    if with_eq:
        np.testing.assert_allclose(nu_t.numpy(), np.asarray(nu_j),
                                   rtol=1e-9, atol=1e-11)
        # The solve satisfies M [x; nu] = [r; b].
        H = Q + rho[:, None, None] * np.eye(n)
        top = np.einsum("bij,bj->bi", H, x_t.numpy()) + np.einsum(
            "bmi,bm->bi", A, nu_t.numpy())
        np.testing.assert_allclose(top, r, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.einsum("bmi,bi->bm", A, x_t.numpy()),
                                   b, rtol=1e-8, atol=1e-10)
    else:
        assert nu_t is None and nu_j is None


@pytest.mark.parametrize("k", [None, 3])
def test_chol_solve_matches_jax(k):
    H = _wishart(6, 2, 30)
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((2, 30) if k is None else (2, 30, k))
    ours = tlin.chol_solve(torch.linalg.cholesky(torch.from_numpy(H)),
                           torch.from_numpy(rhs)).numpy()
    theirs = np.asarray(jlin.chol_solve(jnp.linalg.cholesky(jnp.asarray(H)),
                                        jnp.asarray(rhs)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours, np.linalg.solve(
        H, rhs if k else rhs[..., None]).reshape(ours.shape), rtol=1e-10,
        atol=1e-12)


@pytest.mark.parametrize("n,dtype,equilibrate,k,leaves,rtol", [
    (300, torch.float32, True, 3, 3, 1e-4),   # padded to 384: 1 + 2 leaves
    (256, torch.float32, False, 1, 2, 1e-4),  # no padding, one inverse
    (40, torch.float32, True, 2, 0, 1e-5),    # batch-major Gauss-Jordan
    (300, torch.float64, True, 3, 0, 1e-11),  # Cholesky
])
def test_spd_solve_fast_matches_torch_solve(n, dtype, equilibrate, k,
                                            leaves, rtol, monkeypatch):
    """Against ``torch.linalg.solve`` in float64.  float32 at n=300 takes
    the solve-only recursion with the plain leaf: 384 splits at 128, a
    128 leaf and a 256 inverse of two leaves."""
    leaf_calls = []
    orig = tlin.sweep_spd_inverse
    monkeypatch.setattr(tlin, "sweep_spd_inverse",
                        lambda X, **kw: leaf_calls.append(tuple(X.shape))
                        or orig(X, **kw))
    H = _wishart(8, 2, n)
    R = np.random.default_rng(9).standard_normal((2, n, k))
    X = tlin.spd_solve_fast(torch.tensor(H, dtype=dtype),
                            torch.tensor(R, dtype=dtype),
                            equilibrate=equilibrate, precision="high")
    assert X.dtype == dtype and X.shape == (2, n, k)
    ref = torch.linalg.solve(torch.from_numpy(H), torch.from_numpy(R))
    err = (X.double() - ref).abs().max() / ref.abs().max()
    assert err <= rtol, err.item()
    assert leaf_calls == [(2, 128, 128)] * leaves


def test_schur_solve_rec_matches_jax_recursion():
    """The solve-only recursion against the JAX package's at n=384 in
    float64, with Cholesky leaves on both sides (the JAX recursion takes
    any leaf)."""
    import functools
    H = _wishart(10, 2, 384)
    R = np.random.default_rng(11).standard_normal((2, 384, 2))
    ours = tlin._schur_solve_rec(
        torch.from_numpy(H), torch.from_numpy(R),
        leaf=lambda X, out: out.copy_(tlin.spd_inverse(X))).numpy()
    ee = functools.partial(jnp.einsum, precision="highest")
    theirs = np.asarray(jlin._schur_solve_rec(
        jnp.asarray(H), jnp.asarray(R), ee, leaf=jlin.spd_inverse))
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours, np.linalg.solve(H, R), rtol=1e-9,
                               atol=1e-11)


def _chol_leaf(X, out):
    return out.copy_(tlin.spd_inverse(X))


@pytest.mark.parametrize("form", ["inverse", "solve"])
@pytest.mark.parametrize("n", [256, 384, 640, 1024])
def test_recursion_assembled_in_one_buffer(n, form):
    """The recursion on a diagonal-block view of a larger stack (384 and
    640 split unevenly: 128 + 256, 256 + 384): into a new buffer, into a
    strided view of another stack, and over a copy of its own input, all
    bitwise equal, the caller's operand bitwise unchanged.  float32 with
    the plain sweep leaf against float64 at the tolerances above; float64
    with Cholesky leaves against the JAX recursion with the same leaves."""
    import functools
    ee = functools.partial(jnp.einsum, precision="highest")
    R = np.random.default_rng(n).standard_normal((2, n, 3))
    a = np.random.default_rng(30 + n).standard_normal((2, n, n)) * 0.1
    H64 = a.transpose(0, 2, 1) @ a + np.eye(n)     # _spd's family
    for dtype, leaf in ((np.float32, tlin._sweep_leaf),
                        (np.float64, _chol_leaf)):
        H = H64.astype(dtype)
        big = np.zeros((2, n + 128, n + 128), dtype)
        big[:, 128:, 128:] = H
        view = torch.from_numpy(big)[:, 128:, 128:]
        assert not view.is_contiguous()
        before, own = view.clone(), view.clone()
        if form == "inverse":
            ours = tlin._schur_inverse(view, leaf)
            dst = torch.full((2, n + 64, n + 64), float("nan"),
                             dtype=view.dtype)[:, 64:, 64:]
            assert tlin._schur_inverse(view, leaf, out=dst) is dst
            assert torch.equal(dst, ours)
            assert torch.equal(tlin._schur_inverse(own, leaf, out=own), ours)
            ref = np.linalg.inv(H64)
            jax_rec = functools.partial(jlin._schur_inverse, jnp.asarray(H))
        else:
            Rt = torch.from_numpy(R.astype(dtype))
            ours = tlin._schur_solve_rec(view, Rt, leaf)
            assert torch.equal(
                tlin._schur_solve_rec(own, Rt, leaf, work=own), ours)
            ref = np.linalg.solve(H64, R)
            jax_rec = functools.partial(jlin._schur_solve_rec,
                                        jnp.asarray(H), jnp.asarray(R))
        assert torch.equal(view, before)
        if dtype == np.float32:
            np.testing.assert_allclose(ours.numpy(), ref, rtol=5e-4,
                                       atol=5e-5)
        else:
            theirs = np.asarray(jax_rec(ee, leaf=jlin.spd_inverse))
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-10,
                                       atol=1e-12)
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-9,
                                       atol=1e-11)


@pytest.mark.parametrize("n", [200, 300, 1000])
def test_padded_copy_is_read_only_on_and_above_its_diagonal_blocks(n):
    """``_pad_to_leaf`` leaves the blocks below its 128 diagonal blocks
    unwritten, and the recursion in place on the copy never reads them:
    with NaN there, the inverse and the solve are those of the padded
    matrix, bitwise."""
    a = np.random.default_rng(n).standard_normal((2, n, n)) * 0.1
    H = torch.from_numpy((a.transpose(0, 2, 1) @ a + np.eye(n)).astype(
        np.float32))
    N = -(-n // 128) * 128
    full = torch.eye(N).repeat(2, 1, 1)
    full[:, :n, :n] = H
    R = F.pad(torch.ones((2, n, 2)), (0, 0, 0, N - n))
    Hp = tlin._pad_to_leaf(H)
    band = torch.arange(N) // 128
    Hp[:, band[:, None] > band[None, :]] = float("nan")
    own = Hp.clone()
    assert torch.equal(tlin._schur_solve_rec(own, R, work=own),
                       tlin._schur_solve_rec(full, R))
    assert torch.equal(tlin._schur_inverse(Hp, out=Hp),
                       tlin._schur_inverse(full))


@pytest.mark.parametrize("form", ["inverse", "solve"])
def test_recursion_refuses_an_operand_autograd_records(form, monkeypatch):
    """The in-place GEMMs record no graph: an operand that requires grad
    under grad mode raises before any block is written, and under no_grad
    it is inverted."""
    H = torch.from_numpy(_spd(40, 2, 256, np.float32)).requires_grad_(True)
    R = torch.ones((2, 256, 1))
    call = ((lambda: tlin._schur_inverse(H)) if form == "inverse"
            else (lambda: tlin._schur_solve_rec(H, R)))
    nodes = _count_calls(monkeypatch, "_invert_into")
    with pytest.raises(RuntimeError, match="not differentiable"):
        call()
    assert nodes == []
    with torch.no_grad():
        assert bool(torch.isfinite(call()).all())
    assert len(nodes) >= 1


def _count_calls(monkeypatch, *names):
    """Wrap each named function of ``ops/linalg.py`` to append its name to
    the returned list on every call (the recursion finds them as module
    globals, so its own calls are counted too)."""
    calls = []
    for name in names:
        orig = getattr(tlin, name)
        monkeypatch.setattr(tlin, name, lambda *a, _o=orig, _n=name, **kw:
                            calls.append(_n) or _o(*a, **kw))
    return calls


@pytest.mark.parametrize("layer", ["boxqp", "qp_gen"])
def test_layer_fwd_bwd_assembles_in_place(layer, monkeypatch):
    """A float32 forward and backward of each benchmarked layer (n=200,
    padded to 256) runs the recursion in one buffer, the backward's solve
    included: the autograd Functions factorize outside any graph."""
    import lqp_py_tpu_torch as T
    from lqp_py_tpu_torch.utils.generators import create_qp_data
    Q, p, A, b, lb, ub = create_qp_data(200, 2, seed=3, device="cpu")
    Q.requires_grad_(True)
    p.requires_grad_(True)
    cfg = dict(eps_abs=1e-5, eps_rel=1e-5, symmetrize=False)
    calls = _count_calls(monkeypatch, "_schur_inverse", "_schur_solve_rec")
    if layer == "boxqp":
        x = T.boxqp(Q, p, A, b, lb, ub, config=T.BoxQPConfig(**cfg))
    else:
        eye = torch.eye(200).expand(2, 200, 200)
        x = T.qp_gen(Q, p, A, b, torch.cat([-eye, eye], dim=1),
                     torch.cat([-lb, ub], dim=1),
                     config=T.GenQPConfig(**cfg))
    gQ, gp = torch.autograd.grad(x.sum(), (Q, p))
    assert bool(torch.isfinite(gQ).all()) and bool(torch.isfinite(gp).all())
    assert len(calls) >= 2
