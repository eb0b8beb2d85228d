"""The SWEEP-leaf kernel's pivot-pair recurrence, checked on the CPU.

The CUDA kernel (lqp_py_tpu_torch/csrc/sweep_tile.cuh) runs only on the
card, so its algebra is written out here in torch, in the kernel's order:
pivots in pairs, the pivot rows kept as ``u = row - e_k`` beside their
raw diagonals, row k+1 corrected for pivot k by one term per value, one
rank-2 update per pair, the pivots' diagonal 2 taken off after it and the
result negated.  It is held
against the JAX package's Pallas leaf (interpret mode, as
tests/test_linalg.py runs it), ``numpy.linalg.inv`` and the port's plain
version.  The kernel's thread layout is checked here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqp_py_tpu.ops.pallas import spd_inverse as jsw
from lqp_py_tpu_torch.ops.kernels.spd_inverse import sweep_spd_inverse_ref


def _sweep_pairs(H):
    """The kernel's recurrence on a (B, m, m) stack, m even."""
    A = H.clone()
    m = A.shape[-1]
    eye = torch.eye(m, dtype=A.dtype)
    u1, ub2 = A[:, 0] - eye[0], A[:, 1] - eye[1]     # the pivot buffer
    d1, d2 = A[:, 0, 0], A[:, 1, 1]                  # and its raw diagonals
    for k in range(0, m, 2):
        e = u1[:, k + 1]                             # A[k, k+1]
        dinv1 = 1.0 / d1
        dinv2 = 1.0 / (d2 - e * (e * dinv1))
        v1 = u1 * dinv1[:, None]
        u2 = ub2 - e[:, None] * v1                   # row k+1 after pivot k
        v2 = u2 * dinv2[:, None]
        A = (A - u1[:, :, None] * v1[:, None, :]
             - u2[:, :, None] * v2[:, None, :])
        A[:, k, k] -= 2.0
        A[:, k + 1, k + 1] -= 2.0
        if k + 2 < m:
            u1, ub2 = A[:, k + 2] - eye[k + 2], A[:, k + 3] - eye[k + 3]
            d1, d2 = A[:, k + 2, k + 2], A[:, k + 3, k + 3]
    return -A


def _spd(seed, b, n):
    """SPD stack as tests/test_linalg.py makes it: 0.01 a'a + I."""
    a = np.random.default_rng(seed).standard_normal((b, n, n)) * 0.1
    return np.einsum("bki,bkj->bij", a, a) + np.eye(n)


def _ill_conditioned(seed, b, n, cond):
    """Q diag(lam) Q^T with lam log-spaced over [1/cond, 1]."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    lam = np.logspace(-np.log10(cond), 0, n)
    H = np.einsum("bij,j,bkj->bik", q, lam, q)
    return 0.5 * (H + H.transpose(0, 2, 1))


def test_pairs_float64_match_pallas_leaf_and_numpy():
    H = _spd(0, 3, 128)
    ours = _sweep_pairs(torch.from_numpy(H)).numpy()
    theirs = np.asarray(jsw.sweep_spd_inverse(jnp.asarray(H),
                                              interpret=True))
    ref = np.linalg.inv(H)
    np.testing.assert_allclose(ours, ref, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(ours, theirs, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(
        ours, sweep_spd_inverse_ref(torch.from_numpy(H)).numpy(),
        rtol=1e-11, atol=1e-13)


def test_pairs_float32_within_the_kernel_gates():
    """The card's gates on the kernel (relative 1e-4 against the plain
    version, |H H^-1 - I| <= 1e-4), met by the pair order in float32."""
    H = _spd(1, 3, 128).astype(np.float32)
    Ht = torch.from_numpy(H)
    ours = _sweep_pairs(Ht)
    plain = sweep_spd_inverse_ref(Ht)
    assert (ours - plain).abs().max() <= 1e-4 * plain.abs().max()
    res = np.abs(H.astype(np.float64) @ ours.double().numpy() - np.eye(128))
    assert res.max() <= 1e-4
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jsw.sweep_spd_inverse(jnp.asarray(H),
                                                       interpret=True)),
        rtol=2e-4, atol=2e-5)


def test_pairs_float32_ill_conditioned_no_worse_than_plain():
    """cond ~1e4: the pair order's error against the f64 inverse stays
    within 2x the plain version's, the card test's gate on the kernel."""
    H = _ill_conditioned(2, 3, 128, 1e4)
    inv = np.linalg.inv(H)
    H32 = torch.from_numpy(H.astype(np.float32))
    err_pairs = np.abs(_sweep_pairs(H32).double().numpy() - inv).max()
    err_plain = np.abs(sweep_spd_inverse_ref(H32).double().numpy()
                       - inv).max()
    assert err_pairs <= 2.0 * err_plain, (err_pairs, err_plain)


@pytest.mark.parametrize("ty_n,tx_n", [(16, 16), (32, 16)],
                         ids=["leaf", "block"])
def test_thread_layout_covers_the_tile_and_finds_pivot_owners(ty_n, tx_n):
    """SweepTile<kTY, kTX>: row(r) = (r/4)*4kTY + 4ty + r%4 (columns
    alike) covers 0..127 once over the threads; the thread row and the
    register row that put_pivots picks for an even k hold rows k, k+1, and
    the thread and registers that pair() takes the 2 off hold (k, k)."""
    n_rows, n_cols = 128 // ty_n, 128 // tx_n

    def idx(t, r, n_t):
        return (r // 4) * 4 * n_t + 4 * t + r % 4

    rows = sorted(idx(t, r, ty_n) for t in range(ty_n)
                  for r in range(n_rows))
    cols = sorted(idx(t, c, tx_n) for t in range(tx_n)
                  for c in range(n_cols))
    assert rows == cols == list(range(128))
    for k in range(0, 128, 2):
        ty_k = (k % (4 * ty_n)) // 4
        r_k = (k // (4 * ty_n)) * 4 + k % 4
        assert r_k % 2 == 0 and r_k + 1 < n_rows
        assert (idx(ty_k, r_k, ty_n), idx(ty_k, r_k + 1, ty_n)) == (k, k + 1)
        tx_k = (k % (4 * tx_n)) // 4
        c_k = (k // (4 * tx_n)) * 4 + k % 4
        assert idx(tx_k, c_k, tx_n) == k and idx(tx_k, c_k + 1, tx_n) == k + 1
