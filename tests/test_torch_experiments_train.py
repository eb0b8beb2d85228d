"""The port's Experiment 2 and its paper renderer, the Anderson and the
IP-accuracy drivers, and the README renderer
(``lqp_py_tpu_torch.experiments``) on the CPU at a tiny size.

Each driver runs through ``main([..., "--device", "cpu"])`` into
``tmp_path``; its artifact's keys are held against the committed JAX
artifact's (read, never written).  On the same numpy data, given to both
packages: Experiment 2's first three losses (JAX's features, beta_true
and initial parameters, the shared ``RandomState(0)`` indices) within
1e-4 relative of the JAX driver's; the Anderson driver's ``run_cell`` on
JAX's f32 problems, converged counts equal and ``max_dev_vs_plain``
within 1e-3 of JAX's, and on the well-conditioned family each window's
iterations within one check interval of JAX's (on the hard family the
counts are held in float64, where the two packages factor alike).
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lqp_py_tpu as J
from lqp_py_tpu.models import train as jtrain
from lqp_py_tpu.utils.generators import create_qp_data as j_create
from lqp_py_tpu.utils.generators import generate_hard_qp as j_hard
from lqp_py_tpu_torch import BoxQPConfig, GenQPConfig
from _torch_threads import one_torch_thread  # noqa: F401
from lqp_py_tpu_torch.experiments import (experiment_2, experiment_2_paper,
                                          experiment_aa,
                                          experiment_ip_accuracy, plotting,
                                          render_readme)
from lqp_py_tpu_torch.models.train import make_train_step
from lqp_py_tpu_torch.utils.convert import (linear_qp_from_numpy,
                                            problem_from_numpy)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
TINY2 = ["--n-x", "16", "--n-batch", "8", "--mini-batch", "4", "--epochs",
         "3"]


def _jax_artifact(name):
    return json.loads((REPO / name).read_text())


def _assert_keys_cover(ours, theirs, where):
    missing = set(theirs) - set(ours)
    assert not missing, f"{where}: keys of the JAX artifact missing {missing}"


def test_experiment_2_main_writes_the_jax_schema(tmp_path):
    losses = experiment_2.main([*TINY2, *CPU, "--out-dir", str(tmp_path)])
    ours = json.loads((tmp_path / experiment_2.ARTIFACT).read_text())
    theirs = _jax_artifact("exp2_results.json")
    _assert_keys_cover(ours, theirs, "top level")
    _assert_keys_cover(ours["config"], theirs["config"], "config")
    assert ours["losses"] == losses and len(losses) == 3
    assert ours["fused_vs_loop_loss_dev"] < 1e-3 * max(1.0, abs(losses[0]))


def test_experiment_2_loss_gate_raises():
    with pytest.raises(AssertionError, match="diverge"):
        experiment_2.loss_gate([1.0, 2.0], [1.0, 2.1])
    assert experiment_2.loss_gate([1.0, 2.0], [1.0, 2.0]) == 0.0


def test_experiment_2_losses_match_jax():
    """JAX's driver data (features, beta_true, init_params from
    PRNGKey(0)) and the shared RandomState(0) indices through both
    trainers: the warm-up step, then three epochs, within 1e-4
    relative."""
    n_x, n_f, n_b, mini, tol, lr = 16, 5, 8, 4, 1e-5, 5e-4
    data = j_create(n_x, n_b, seed=0, dtype=jnp.float32)
    kf, kb, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    features = jax.random.normal(kf, (n_b, n_f), jnp.float32)
    beta_true = jax.random.normal(kb, (n_f, n_x), jnp.float32)
    full_j = (features, data.Q, features @ beta_true, data.A, data.b,
              data.lb, data.ub)
    params_j = jtrain.init_params(kp, n_f, n_x, jnp.float32)
    sel = experiment_2.minibatch_indices(n_b, mini, 3)

    full_t = tuple(torch.tensor(np.asarray(a)) for a in full_j)
    params_t = linear_qp_from_numpy(
        jtrain.LinearQPParams(W=np.asarray(params_j.W),
                              bias=np.asarray(params_j.bias)),
        device="cpu")

    step_j = jax.jit(jtrain.make_train_step(
        J.BoxQPConfig(eps_abs=tol, eps_rel=tol), lr=lr))
    losses_j = []
    for idx in [np.arange(mini), *sel]:
        params_j, loss = step_j(params_j, *(v[idx] for v in full_j))
        losses_j.append(float(loss))

    step_t = make_train_step(BoxQPConfig(eps_abs=tol, eps_rel=tol), lr=lr)
    params_t, first = experiment_2.warm_up(step_t, params_t, full_t, mini)
    _, losses_t, _ = experiment_2.run_loop(step_t, params_t, full_t, sel,
                                           "cpu", log_every=0)
    np.testing.assert_allclose([first, *losses_t], losses_j, rtol=1e-4)


def test_experiment_2_paper_renders_torch_charts(tmp_path, monkeypatch):
    real = experiment_2.main
    monkeypatch.setattr(experiment_2, "main",
                        lambda argv: real([*argv, *TINY2]))
    written = experiment_2_paper.main(["--run", *CPU, "--out-dir",
                                       str(tmp_path)])
    if plotting.pyplot() is None:
        assert written == []
    else:
        assert sorted(p.name for p in written) == sorted(
            f"exp2_paper_{kind}_dz_16_torch.{ext}"
            for kind in ("time", "conv") for ext in ("pdf", "png"))
        assert all(p.exists() for p in written)
    monkeypatch.setattr(plotting, "pyplot", lambda: None)
    monkeypatch.setattr(experiment_2_paper, "pyplot", lambda: None)
    assert experiment_2_paper.render(tmp_path / experiment_2.ARTIFACT,
                                     tmp_path) == []


def test_experiment_aa_main_writes_the_jax_schema(tmp_path):
    experiment_aa.main(["--sizes", "16", "--n-batch", "4", "--windows", "4",
                        "--n-sims", "1", *CPU, "--out-dir", str(tmp_path)])
    ours = json.loads((tmp_path / experiment_aa.ARTIFACT).read_text())
    theirs = _jax_artifact("exp_aa_results.json")
    _assert_keys_cover(ours, theirs, "top level")
    assert set(ours["results"]) == {"hard_n16", "create_n16"}
    for cell in ours["results"].values():
        assert set(cell) == {"box_aa0", "gen_aa0", "box_aa4", "gen_aa4"}
        for name, rec in cell.items():
            _assert_keys_cover(rec, theirs["results"]["hard_n50"][
                name.replace("aa4", "aa10")], name)
            assert rec["n_converged"] == 4


def _aa_cells(family, dtype, windows):
    """The Anderson cell in both packages on the JAX generator's problems
    (``dtype``): JAX's ``run_cell`` (f32) or the same solves jitted (f64),
    and the port's ``run_cell`` on the same numpy data."""
    from experiments.experiment_aa import run_cell as j_run_cell
    n, b, tol = 16, 4, 1e-5
    gen = j_hard if family == "hard" else j_create
    jd = gen(n, b, seed=0, dtype=dtype)
    if dtype == jnp.float32:
        theirs = j_run_cell(family, n, b, tol, windows, 1)
    else:
        from lqp_py_tpu.models.genqp import solve_qp_gen
        G, h = jd.with_G_h()
        theirs = {}
        for m in [0, *windows]:
            box_cfg = J.BoxQPConfig(eps_abs=tol, eps_rel=tol, acceleration=m)
            gen_cfg = J.GenQPConfig(eps_abs=tol, eps_rel=tol, acceleration=m)
            s = jax.jit(lambda *a, c=box_cfg: J.solve_box_qp(*a, config=c))(
                *jd)
            theirs[f"box_aa{m}"] = {"iters": int(s.iterations)}
            s = jax.jit(lambda *a, c=gen_cfg: solve_qp_gen(*a, config=c))(
                jd.Q, jd.p, jd.A, jd.b, G, h)
            theirs[f"gen_aa{m}"] = {"iters": int(s.iterations)}
    ours = experiment_aa.run_cell(
        family, n, b, tol, windows, 1, "cpu", data=problem_from_numpy(
            *(np.asarray(a) for a in jd), device="cpu"))
    return ours, theirs


@pytest.mark.parametrize("family", ["hard", "create"])
def test_experiment_aa_run_cell_matches_jax(family):
    """f32, windows 0 and 10: converged counts equal and
    ``max_dev_vs_plain`` within 1e-3 of JAX's; on the well-conditioned
    'create' family each cell's iterations within one check interval.  On
    the 'hard' family the f32 counts part (plain box ADMM 150 against 131
    at n=16: the port's f32 factorization is the recursion with the plain
    leaf, JAX's Cholesky) and so do the box Anderson counts even in f64
    (below; tests/test_torch_experiments_aa.py holds those to each
    package's one-ulp rounding spread)."""
    ours, theirs = _aa_cells(family, jnp.float32, [10])
    assert set(ours) == set(theirs)
    box_cs = BoxQPConfig().resolved_check_interval(16)
    gen_cs = GenQPConfig().check_solved
    for name, rec in theirs.items():
        assert ours[name]["n_converged"] == rec["n_converged"], name
        if "max_dev_vs_plain" in rec:
            assert abs(ours[name]["max_dev_vs_plain"]
                       - rec["max_dev_vs_plain"]) <= 1e-3, name
        if family == "create":
            cs = box_cs if name.startswith("box") else gen_cs
            assert abs(ours[name]["iters"] - rec["iters"]) <= cs, name


def test_experiment_aa_hard_counts_match_jax_in_f64():
    """float64 on the hard family: the plain box ADMM and GenQP with and
    without Anderson take JAX's iteration counts exactly; box Anderson's
    counts part, within what one ulp of the input moves either package's
    own (tests/test_torch_experiments_aa.py)."""
    ours, theirs = _aa_cells("hard", jnp.float64, [10])
    for name in ("box_aa0", "gen_aa0", "gen_aa10"):
        assert ours[name]["iters"] == theirs[name]["iters"], name


def test_experiment_ip_accuracy_main_writes_the_jax_schema(tmp_path):
    cells = experiment_ip_accuracy.main([
        "--sizes", "24", "--n-batch", "4", "--n-reps", "1", "--n-oracle",
        "2", *CPU, "--out-dir", str(tmp_path)])
    ours = json.loads((tmp_path / experiment_ip_accuracy.ARTIFACT)
                      .read_text())
    theirs = _jax_artifact("ip_accuracy_results.json")
    _assert_keys_cover(ours, theirs, "top level")
    assert len(cells) == 14 and ours["cells"] == cells
    for c in cells:
        _assert_keys_cover(c, theirs["cells"][0], "cell")
        assert c["max_dev_x_vs_tight"] < 1e-1
    by_key = {(c["solver"], c["refine_steps"], c["polish"]): c
              for c in cells}
    # The polish lifts both interior points towards the f64 oracle.
    for solver in ("OptNet_IP", "BoxIP"):
        assert (by_key[(solver, 0, True)]["max_dev_x_vs_f64"]
                <= by_key[(solver, 0, False)]["max_dev_x_vs_f64"])


def _block(text):
    return text.split(render_readme.BEGIN)[1].split(render_readme.END)[0]


def test_readme_block_is_the_render_of_the_committed_artifacts():
    """README's port block is what the renderer makes of the committed
    ``*_torch.json`` artifacts, and every captured number in it comes
    from them."""
    readme = (REPO / "README.md").read_text()
    assert _block(readme) == _block(render_readme.render(REPO))


def test_render_readme_writes_only_its_block(tmp_path):
    shutil.copy(REPO / "README.md", tmp_path / "README.md")
    before = (tmp_path / "README.md").read_text()
    render_readme.main(["--readme", str(tmp_path / "README.md"),
                        "--artifacts-dir", str(tmp_path)])
    after = (tmp_path / "README.md").read_text()
    assert before.split(render_readme.BEGIN)[0] == after.split(
        render_readme.BEGIN)[0]
    assert before.split(render_readme.END)[1] == after.split(
        render_readme.END)[1]
    # No artifact: every section renders as "not captured", no number.
    lines = [line for line in _block(after).splitlines() if line]
    assert len(lines) == 9 and lines[-1].startswith("Regenerate")
    assert all(line.endswith("_torch.json`).") and "not captured" in line
               for line in lines[:-1])
    (tmp_path / "README.md").write_text("no markers\n")
    with pytest.raises(SystemExit):
        render_readme.main(["--readme", str(tmp_path / "README.md")])
