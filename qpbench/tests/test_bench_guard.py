"""The harness's refusals: JAX or the JAX package loaded, no card, and a
checkout that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

from qpbench import guard, harness


def test_guard_names_jax_and_the_jax_package():
    assert guard.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "numpy",
         "lqp_py_tpu", "lqp_py_tpu.models.box_qp"]) == [
        "flax", "jax", "jaxlib", "lqp_py_tpu"]


def test_guard_accepts_the_port():
    assert guard.forbidden_modules(
        ["lqp_py_tpu_torch", "lqp_py_tpu_torch.models.box_qp", "torch",
         "jax_like", "qpbench.run"]) == []


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "qpbench/run.py", "--workload", "exp1-serve-warm",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    """Without a card (this machine) the run fails and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(harness.ROOT, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """A directory with BENCHMARK.json and qpbench/ alone: no result."""
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, imported into a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, '.');"
            "import qpbench.run, qpbench.judge, qpbench.trace;"
            "from qpbench import harness, guard;"
            "[harness.Cell(w['name']).solver for w in "
            "harness.manifest()['workloads']];"
            "[harness.Cell(w['name']).kind for w in "
            "harness.manifest()['workloads']];"
            "print(guard.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
