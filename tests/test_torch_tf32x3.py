"""The arithmetic of the block-sweep inverse's tensor-core products
(csrc/block_spd_inverse.cu), emulated on the CPU.

The kernel multiplies float32 panels on the tensor cores in TF32 (10
explicit mantissa bits), three passes per product: with hi = rna(x) and
lo = rna(x - hi), A B ~= A_lo B_hi + A_hi B_lo + A_hi B_hi, accumulated in
float32.  It keeps only the upper block triangle of M during the sweep and
mirrors it at the end.  Here TF32 rounding is done with integer operations
on the float32 bits, each TF32 x TF32 product is exact in float32 (11 x 11
significant bits), so a float32 matmul of TF32-valued operands is the
tensor core's product up to the order of the float32 sums; the sweep is
replayed step for step with those products and held against the JAX
package's Pallas kernel (interpret mode) and a float64 inverse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqp_py_tpu.ops.pallas import block_inverse as jbi
from lqp_py_tpu_torch.ops.kernels.spd_inverse import sweep_spd_inverse_ref

BLK = 128


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32, to nearest with ties away from zero (PTX
    cvt.rna.tf32.f32): add half a TF32 unit to the magnitude bits, then
    clear the 13 low mantissa bits (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernel computes it: three TF32 passes, float32 sums."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def block_sweep_3xtf32(H: torch.Tensor) -> torch.Tensor:
    """The kernel's sweep: only tiles I <= J of M are kept; per pivot block
    K, W = C (-D^-1) and M[I,J] += W[I] C[J]^T on the upper tiles, then
    V = -W written back to column block K above K and row block K right of
    it; the lower triangle is mirrored at the end, negated."""
    B, n, _ = H.shape
    nb = n // BLK
    M = H.clone()

    def t(I, J):
        return (slice(None), slice(I * BLK, (I + 1) * BLK),
                slice(J * BLK, (J + 1) * BLK))

    for I in range(nb):                        # the kernel never reads these
        for J in range(I):
            M[t(I, J)] = float("nan")
    for kb in range(nb):
        Dn = -sweep_spd_inverse_ref(M[t(kb, kb)])  # -D^-1
        M[t(kb, kb)] = Dn
        others = [I for I in range(nb) if I != kb]
        # C rows of block I: M[I, K] above K, M[K, I]^T below it.
        C = {I: (M[t(I, kb)] if I < kb else M[t(kb, I)].mT).clone()
             for I in others}
        # W^T = (-D^-1) C^T, held operand -D^-1 (symmetric).
        W = {I: mm_3xtf32(Dn, C[I].mT).mT for I in others}
        for I in others:
            for J in others:
                if J >= I:
                    M[t(I, J)] += mm_3xtf32(W[I], C[J].mT)
        for I in others:
            if I < kb:
                M[t(I, kb)] = -W[I]
            else:
                M[t(kb, I)] = -W[I].mT
    for I in range(nb):
        for J in range(I):
            M[t(I, J)] = M[t(J, I)].mT
        D = M[t(I, I)]
        M[t(I, I)] = torch.triu(D) + torch.triu(D, 1).mT
    return -M


def _spd(seed, b, n):
    """SPD stack as tests/test_linalg.py makes it: 0.01 a'a + I."""
    a = np.random.default_rng(seed).standard_normal((b, n, n)) * 0.1
    return (np.einsum("bki,bkj->bij", a, a) + np.eye(n)).astype(np.float32)


def test_tf32_rounding_matches_the_format():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0 * 2.0 ** -12, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 3.0 * 2.0 ** -12, 0.0])
    assert torch.equal(tf32_rna(x), want)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi + lo keeps ~22 bits: within 2^-21 of x, relative.
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_product_is_as_accurate_as_float32(seed):
    """At depth 128, the panel products' depth, the split product's error
    against float64 stays within 4x that of a full-float32 matmul: its
    dropped lo*lo term and the two roundings are ~2^-22 relative per
    product, the size of float32's own rounding, so only the constant
    differs (4x leaves room for the sum order).  One TF32 pass keeps ~11
    bits (2^-11 per product) and misses the bound by two orders: that is
    why the kernel splits."""
    rng = np.random.default_rng(seed)
    a64 = rng.standard_normal((256, 128))
    b64 = rng.standard_normal((128, 256))
    a, b = (torch.from_numpy(v.astype(np.float32)) for v in (a64, b64))
    exact = a.double() @ b.double()
    err_f32 = float((a @ b - exact).abs().max())
    err_3x = float((mm_3xtf32(a, b).double() - exact).abs().max())
    err_1x = float((mm_tf32(a, b).double() - exact).abs().max())
    assert err_3x <= 4 * err_f32, (err_3x, err_f32)
    assert err_1x > 4 * err_f32, (err_1x, err_f32)
    assert err_1x > 50 * err_3x, (err_1x, err_3x)


@pytest.mark.parametrize("n", [256, 384])
def test_emulated_symmetric_sweep_matches_jax_kernel_and_float64(n):
    H = _spd(7 + n, 2, n)
    ours = block_sweep_3xtf32(torch.from_numpy(H))
    assert bool(torch.isfinite(ours).all())
    assert torch.equal(ours, ours.mT)
    ours = ours.numpy()
    theirs = np.asarray(jbi.block_spd_inverse(jnp.asarray(H), interpret=True))
    ref = np.linalg.inv(H.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() <= 1e-4 * scale
    assert np.abs(ours - theirs).max() <= 1e-4 * scale
    R = np.einsum("bij,bjk->bik", H.astype(np.float64),
                  ours.astype(np.float64)) - np.eye(n)
    assert np.abs(R).max() <= 1e-4
