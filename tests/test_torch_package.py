"""Hygiene of the PyTorch port: its configuration matches the JAX
package's, it never imports JAX, and the SWEEP-leaf wrapper takes the plain
version only for CPU tensors."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lqp_py_tpu import config as jcfg
from lqp_py_tpu_torch import (BoxQPConfig, GenQPConfig, OptNetConfig,
                              box_qp_control, genqp_control, optnet_control,
                              scs_control)
from lqp_py_tpu_torch import config as tcfg
from lqp_py_tpu_torch.ops.kernels import _build
from lqp_py_tpu_torch.ops.kernels import spd_inverse as sk

REPO = Path(__file__).resolve().parents[1]


def _defaults(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_match_jax():
    assert _defaults(BoxQPConfig) == _defaults(jcfg.BoxQPConfig)
    assert box_qp_control(eps_abs=1e-5) == BoxQPConfig(eps_abs=1e-5)
    assert _defaults(OptNetConfig) == _defaults(jcfg.OptNetConfig)
    assert optnet_control(tol=1e-5) == OptNetConfig(tol=1e-5)
    with pytest.raises(TypeError):
        optnet_control(not_a_knob=1)
    assert _defaults(GenQPConfig) == _defaults(jcfg.GenQPConfig)
    assert genqp_control(eps_abs=1e-5) == GenQPConfig(eps_abs=1e-5)
    with pytest.raises(TypeError):
        genqp_control(not_a_knob=1)
    with pytest.raises(ValueError) as theirs:
        jcfg.GenQPConfig(acceleration=-1)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        GenQPConfig(acceleration=-1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(normalize=False, scale=0.7, adaptive_scale=False, rho_x=1e-5,
         alpha=1.5, eps_abs=1e-6, eps_rel=1e-7, max_iters=500,
         verbose=True),
    dict(acceleration_lookback=-10),
    dict(acceleration_lookback=5, acceleration=3),
    dict(eps_infeas=1e-7, detect_infeasibility=False),
    dict(use_indirect=True, time_limit_secs=3.0, ignore_unsupported=True),
    dict(mkl=True, gpu=False),
    dict(acceleration_interval=10),
    dict(not_a_knob=1),
], ids=["defaults", "renames", "lookback", "lookback-and-acceleration",
        "eps-infeas", "ignored", "unsupported", "unsupported-aa-interval",
        "unknown"])
def test_scs_control_maps_and_raises_like_jax(kw):
    """The reference's SCS knob names map onto the same ``GenQPConfig``;
    knobs with no counterpart raise the same error, naming the port."""
    try:
        theirs = jcfg.scs_control(**kw)
    except (TypeError, ValueError) as err:
        with pytest.raises(type(err)) as ours:
            scs_control(**kw)
        if isinstance(err, ValueError):
            # The same knobs, the port named in place of the JAX package.
            assert str(err).split(" have ")[0] == str(ours.value).split(
                " have ")[0]
            assert "lqp_py_tpu_torch" in str(ours.value)
            assert "TPU" not in str(ours.value)
        return
    assert _defaults(type(scs_control(**kw))) == _defaults(GenQPConfig)
    assert (dataclasses.asdict(scs_control(**kw))
            == dataclasses.asdict(theirs))


@pytest.mark.parametrize("n", [1, 10, 50, 150, 1000, 10_000])
def test_config_intervals_match_jax(n):
    for kw in ({}, {"check_solved": 7, "adaptive_rho_iter": 30}):
        ours, theirs = BoxQPConfig(**kw), jcfg.BoxQPConfig(**kw)
        assert (ours.resolved_check_interval(n)
                == theirs.resolved_check_interval(n))
        assert (ours.resolved_adaptive_interval(n)
                == theirs.resolved_adaptive_interval(n))


@pytest.mark.parametrize("kw", [
    dict(alpha=0.0), dict(alpha=2.0), dict(acceleration=-1),
    dict(acceleration=2, use_pallas_step=True),
    dict(acceleration=2, unroll=True), dict(polish=True, unroll=True),
], ids=["alpha0", "alpha2", "negative-aa", "aa-pallas", "aa-unroll",
        "polish-unroll"])
def test_config_checks_raise_like_jax(kw):
    with pytest.raises(ValueError) as theirs:
        jcfg.BoxQPConfig(**kw)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        BoxQPConfig(**kw)
    with pytest.raises(TypeError):
        box_qp_control(not_a_knob=1)
    assert tcfg._check_interval_default(1000) == 4


def test_vector_layout_helpers_match_jax():
    import jax.numpy as jnp
    from lqp_py_tpu import types as jtypes
    from lqp_py_tpu_torch import types as ttypes

    v3 = torch.arange(6.0).reshape(2, 3, 1)
    v2 = ttypes.as_vector(v3)
    assert tuple(v2.shape) == (2, 3) and ttypes.as_vector(None) is None
    assert torch.equal(ttypes.like_layout(v2, v3), v3)
    assert ttypes.like_layout(v2, v2) is v2
    assert (np.asarray(jtypes.as_vector(jnp.asarray(v3.numpy())))
            == v2.numpy()).all()
    for bad in (torch.zeros(2, 3, 2), torch.zeros(3)):
        with pytest.raises(ValueError):
            ttypes.as_vector(bad)
        with pytest.raises(ValueError):
            jtypes.as_vector(jnp.asarray(bad.numpy()))


PORT_MODULES = sorted(
    ".".join(f.relative_to(REPO).with_suffix("").parts)
    for f in (REPO / "lqp_py_tpu_torch").rglob("*.py")
    if f.name != "__init__.py")


def test_import_leaves_jax_out():
    assert {"lqp_py_tpu_torch.models.box_qp_grad",
            "lqp_py_tpu_torch.models.layers", "lqp_py_tpu_torch.models.train",
            "lqp_py_tpu_torch.models._stateful", "lqp_py_tpu_torch.nn",
            "lqp_py_tpu_torch.ops.kernels.block_inverse",
            "lqp_py_tpu_torch.models._polish", "lqp_py_tpu_torch.models.eqcon",
            "lqp_py_tpu_torch.models.uncon",
            "lqp_py_tpu_torch.ops.anderson",
            "lqp_py_tpu_torch.models.box_ip",
            "lqp_py_tpu_torch.models.optnet",
            "lqp_py_tpu_torch.models.genqp",
            "lqp_py_tpu_torch.models.conic_grad",
            "lqp_py_tpu_torch.utils.profiling",
            "lqp_py_tpu_torch.utils.checkpoint"} <= set(PORT_MODULES)
    code = ("import sys, importlib\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'lqp_py_tpu')]\n"
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", [
    "solve_box_qp_unrolled", "EqQPSolution", "qp_eqcon", "solve_qp_eqcon",
    "qp_uncon", "solve_qp_uncon", "solve_box_qp", "prepare_box_qp",
    "solve_box_qp_prepared", "boxqp", "BoxQPLayer", "BoxQP", "BoxQPConfig",
    "box_qp_control", "BoxQPSolution", "OptNetConfig", "optnet_control",
    "QPSolution", "solve_box_qp_ip", "boxqp_ip", "solve_qp_optnet",
    "qp_optnet", "OptNetLayer", "GenQPConfig", "genqp_control",
    "scs_control", "prepare_qp_gen", "solve_qp_gen_prepared", "GenQP",
    "GenQPLayer", "qp_gen", "solve_qp_gen"])
def test_exports_the_jax_package_names_it_ports(name):
    import lqp_py_tpu
    import lqp_py_tpu_torch
    assert name in lqp_py_tpu.__all__ and name in lqp_py_tpu_torch.__all__
    assert callable(getattr(lqp_py_tpu_torch, name))


def test_eq_solution_fields_match_jax():
    from lqp_py_tpu import types as jtypes
    from lqp_py_tpu_torch import EqQPSolution
    assert ([f.name for f in dataclasses.fields(EqQPSolution)]
            == [f.name for f in dataclasses.fields(jtypes.EqQPSolution)])


def test_qp_solution_fields_match_jax():
    from lqp_py_tpu import types as jtypes
    from lqp_py_tpu_torch import QPSolution
    assert ([f.name for f in dataclasses.fields(QPSolution)]
            == [f.name for f in dataclasses.fields(jtypes.QPSolution)])


def test_optnet_module_and_box_as_inequalities():
    """``nn.OptNetModule`` is the interior-point layer holding its config,
    ``nn.GenQPModule`` the splitting layer;
    ``QPData.with_G_h`` writes the box as G = [-I; I], h = [-lb; ub] on the
    data's device and dtype, as the JAX package does."""
    import jax.numpy as jnp
    from lqp_py_tpu.utils.generators import create_qp_data as jcreate
    from lqp_py_tpu_torch import OptNetLayer
    from lqp_py_tpu_torch import nn as tnn
    from lqp_py_tpu_torch.utils.convert import problem_from_numpy

    assert tnn.OptNetModule is OptNetLayer
    from lqp_py_tpu_torch import GenQPLayer
    assert tnn.GenQPModule is GenQPLayer
    assert isinstance(tnn.GenQPModule(), torch.nn.Module)
    layer = tnn.OptNetModule(OptNetConfig(tol=1e-6))
    assert isinstance(layer, torch.nn.Module) and layer.config.tol == 1e-6
    jd = jcreate(5, 2, seed=1, dtype=jnp.float64)
    td = problem_from_numpy(*(np.asarray(a) for a in jd), device="cpu")
    G, h = td.with_G_h()
    jG, jh = jd.with_G_h()
    assert G.dtype == h.dtype == torch.float64 and G.device == td.Q.device
    assert torch.equal(G, torch.tensor(np.asarray(jG)))
    assert torch.equal(h, torch.tensor(np.asarray(jh)))


def test_sweep_wrapper_takes_plain_version_on_cpu():
    H = torch.eye(128, dtype=torch.float32).expand(3, 128, 128) * 2.0
    before = sk.LAUNCHES
    out = sk.sweep_spd_inverse(H)
    assert sk.LAUNCHES == before
    assert torch.equal(out, sk.sweep_spd_inverse_ref(H))
    assert torch.allclose(out, 0.5 * torch.eye(128))


def test_sweep_wrapper_refuses_other_devices():
    H = torch.empty((2, 128, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.sweep_spd_inverse(H)


def test_library_name_follows_source_content(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR


_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
def note(what):
    with open({log!r}, "a") as f:
        f.write(f"{{what}} {{time.time()}} {{' '.join(args)}}\\n")
note("start")
if "-c" in args:
    time.sleep(1.0)
    if "bad.cu" in args[-1]:
        note("end")
        sys.exit("bad.cu: error")
open(out, "w").write("obj")
note("end")
"""


@pytest.mark.parametrize("bad", [False, True], ids=["ok", "one-fails"])
def test_build_compiles_each_source_side_by_side(tmp_path, monkeypatch,
                                                 bad):
    """One compiler process per source, all started before any ends, then
    one link of every object; a failing source raises with its output and
    leaves no library behind."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "bad.cu" if bad else "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    out = _build.library_path()
    if bad:
        with pytest.raises(RuntimeError, match="bad.cu: error"):
            _build._compile(out)
        assert not out.exists()
    else:
        _build._compile(out)
        assert out.read_text() == "obj"
    calls = [line.split(" ", 2) for line in log.read_text().splitlines()]
    compiles = [(what, float(t)) for what, t, a in calls
                if "-c" in a.split()]
    starts = [t for what, t in compiles if what == "start"]
    ends = [t for what, t in compiles if what == "end"]
    assert len(starts) == len(ends) == 3
    assert max(starts) < min(ends)
    links = [a.split() for what, _, a in calls
             if what == "start" and "-shared" in a.split()]
    assert len(links) == (0 if bad else 1)
    if not bad:
        assert sum(a.endswith(".o") for a in links[0]) == 3
    assert list((tmp_path / "build").iterdir()) == ([] if bad else [out])


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load_library()
    finally:
        _build.load_library.cache_clear()


def test_data_entry_points_default_to_the_card():
    """Problem generators and converters put their tensors on the card
    unless the caller names another device; without CUDA a call that names
    none raises."""
    import inspect

    from lqp_py_tpu_torch import nn as tnn
    from lqp_py_tpu_torch.models import train as ttrain
    from lqp_py_tpu_torch.utils import convert, generators

    fns = [generators.create_qp_data, generators.generate_hard_qp,
           convert.problem_from_numpy, convert.prepared_from_numpy,
           convert.solution_from_numpy, convert.linear_qp_from_numpy,
           convert.linear_box_qp_from_flax, convert.gen_problem_from_numpy,
           convert.qp_solution_from_numpy, convert.ip_factors_from_numpy,
           convert.gen_prepared_from_numpy,
           ttrain.init_params,
           tnn.LinearBoxQP.__init__]
    for fn in fns:
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default) == torch.device("cuda"), fn.__name__
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            generators.create_qp_data(4, 2)
