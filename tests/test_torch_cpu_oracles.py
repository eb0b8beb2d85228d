"""The port's own CPU oracles (``lqp_py_tpu_torch/cpu/``) against the JAX
package's: the numpy scalar ADMM gives bitwise the JAX copy's output, and
the port's ctypes binding, built by ``g++`` from ``native/lqp_native.cpp``
into a build directory of its own, matches ``lqp_py_tpu/cpu/native.py``'s
x to 1e-10 in float64 without touching ``native/``.  The native tests
skip only where ``g++`` is absent."""

import hashlib
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from lqp_py_tpu.cpu import boxqp_numpy as jnp_oracle
from lqp_py_tpu.cpu import native as jnative
from lqp_py_tpu.utils.generators import create_qp_data, generate_hard_qp
from lqp_py_tpu_torch.cpu import boxqp_numpy as tnp_oracle
from lqp_py_tpu_torch.cpu import native as tnative

REPO = Path(__file__).resolve().parents[1]
SO = REPO / "native" / "liblqp_native.so"


def _problems():
    easy = [np.asarray(a, np.float64) for a in create_qp_data(
        20, 3, seed=0, dtype=jnp.float64)]
    hard = [np.asarray(a, np.float64) for a in generate_hard_qp(
        16, 2, seed=1, dtype=jnp.float64)]
    return easy, hard


@pytest.mark.parametrize("case", ["easy", "hard", "no-A", "no-scale"])
def test_numpy_oracle_is_bitwise_the_jax_copy(case):
    easy, hard = _problems()
    d = hard if case == "hard" else easy
    kw = dict(eps_abs=1e-9, eps_rel=1e-9)
    if case == "no-scale":
        kw.update(scale=False, adaptive_rho=False)
    for i in range(d[0].shape[0]):
        args = [a[i] for a in d]
        if case == "no-A":
            args[2] = args[3] = None
        ours = tnp_oracle.solve_box_qp_np(*args, **kw)
        theirs = jnp_oracle.solve_box_qp_np(*args, **kw)
        assert ours.keys() == theirs.keys()
        for k, v in theirs.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
            else:
                assert ours[k] == v, k


def test_numpy_oracle_stateful_wrapper_is_bitwise_the_jax_copy():
    easy, _ = _problems()
    args = [a[0] for a in easy]
    ours = tnp_oracle.BoxQPNumpy(*args, eps_abs=1e-8, eps_rel=1e-8)
    theirs = jnp_oracle.BoxQPNumpy(*args, eps_abs=1e-8, eps_rel=1e-8)
    for _ in range(2):
        np.testing.assert_array_equal(ours.solve(), theirs.solve())
        assert ours.sol["iter"] == theirs.sol["iter"]
        ours.update(p=args[1] * 0.5)
        theirs.update(p=args[1] * 0.5)


@pytest.fixture
def own_build(tmp_path, monkeypatch):
    """The port's binding built into ``tmp_path``; ``native/`` hashed before
    and after."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    before = hashlib.sha256(SO.read_bytes()).hexdigest()
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native-build")
    tnative.load_library.cache_clear()
    yield tmp_path / "native-build"
    tnative.load_library.cache_clear()
    assert hashlib.sha256(SO.read_bytes()).hexdigest() == before
    assert sorted(p.name for p in SO.parent.iterdir()) == [
        "Makefile", "liblqp_native.so", "lqp_native.cpp"]


def test_native_binding_builds_its_own_library(own_build):
    assert tnative.available()
    built = list(own_build.iterdir())
    assert built == [tnative.library_path()]
    assert built[0].name.startswith("liblqp_native_")
    assert "-march=native" not in tnative.CXX_FLAGS


@pytest.mark.parametrize("threads", [1, 2])
def test_native_binding_matches_the_jax_binding(own_build, threads):
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load here")
    easy, hard = _problems()
    for d in (easy, hard):
        ours = tnative.solve_box_qp_native(*d, eps_abs=1e-10, eps_rel=1e-10,
                                           n_threads=threads)
        theirs = jnative.solve_box_qp_native(*d, eps_abs=1e-10,
                                             eps_rel=1e-10,
                                             n_threads=threads)
        np.testing.assert_allclose(ours["x"], theirs["x"], rtol=0,
                                   atol=1e-10)
        assert ours["status"] == theirs["status"] == 0


def test_native_unavailable_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    tnative.load_library.cache_clear()
    try:
        assert not tnative.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            tnative.solve_box_qp_native(np.eye(2)[None], np.ones((1, 2)))
    finally:
        tnative.load_library.cache_clear()
