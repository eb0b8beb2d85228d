"""Parity of the port's whole-matrix block-sweep inverse
(lqp_py_tpu_torch.ops.kernels.block_inverse) with the JAX package's Pallas
kernel, run in interpret mode as tests/test_linalg.py runs it.  The CUDA
kernel itself is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqp_py_tpu.ops.pallas import block_inverse as jbi
from lqp_py_tpu_torch.ops.kernels import block_inverse as bk


def _spd(seed, b, n):
    """SPD stack as tests/test_linalg.py makes it: 0.01 a'a + I."""
    a = np.random.default_rng(seed).standard_normal((b, n, n)) * 0.1
    return (np.einsum("bki,bkj->bij", a, a) + np.eye(n)).astype(np.float32)


def test_plain_block_sweep_matches_jax_kernel_and_numpy():
    # The bounds of tests/test_linalg.py's block-sweep test.
    H = _spd(5, 3, 384)
    before = bk.LAUNCHES
    ours = bk.block_spd_inverse(torch.from_numpy(H))
    assert bk.LAUNCHES == before                 # CPU: the plain version
    assert ours.dtype == torch.float32 and ours.shape == (3, 384, 384)
    ours = ours.numpy()
    theirs = np.asarray(jbi.block_spd_inverse(jnp.asarray(H),
                                              interpret=True))
    ref = np.linalg.inv(H.astype(np.float64))
    for got in (ours, theirs):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
        R = np.einsum("bij,bjk->bik", H.astype(np.float64),
                      got.astype(np.float64)) - np.eye(384)
        assert np.max(np.abs(R)) < 5e-5
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-5)


def test_plain_block_sweep_float64_is_exact_to_roundoff():
    H = _spd(6, 2, 256).astype(np.float64)
    ours = bk.block_spd_inverse_ref(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(ours, np.linalg.inv(H), rtol=1e-11,
                               atol=1e-13)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("shape", [(2, 200, 200), (2, 128, 256), (128, 128)],
                         ids=["n-not-128", "not-square", "rank-2"])
def test_wrapper_refuses_shapes_the_kernel_does_not_take(shape, device):
    before = bk.LAUNCHES
    with pytest.raises(ValueError, match="multiple of 128"):
        bk.block_spd_inverse(torch.empty(shape, device=device))
    assert bk.LAUNCHES == before


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        bk.block_spd_inverse(torch.empty((2, 128, 128), device="meta"))
