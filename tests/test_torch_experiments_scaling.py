"""The port's scaling driver (``experiment_scaling``) on the CPU: one world
of gloo ranks per mesh size {1, N/2, N} started through
``parallel/launch.py``, the batch-sharded solves (lock step and
shard_map) within 1e-4 of the single-process solve in every world, and
the tp=N solve within 1e-4 with less per-rank memory than tp=1.  Alone in
its file because it starts worlds of processes."""

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from lqp_py_tpu_torch.experiments import experiment_scaling


def test_world_sizes_are_one_half_and_all():
    assert experiment_scaling.world_sizes(4) == [1, 2, 4]
    assert experiment_scaling.world_sizes(2) == [1, 2]
    assert experiment_scaling.world_sizes(1) == [1]


def test_scaling_driver_on_cpu_gloo_ranks(capsys):
    worlds = experiment_scaling.main(["--device", "cpu", "--nproc", "4",
                                      "--n-x", "16", "--per-dev-batch", "2"])
    assert sorted(worlds) == [1, 2, 4]
    for d, ranks in worlds.items():
        assert [r["rank"] for r in ranks] == list(range(d))
        assert sum(r["converged"] for r in ranks) == 2 * d
        for r in ranks:
            assert r["err_sharded"] < experiment_scaling.GATE
            assert r["err_shard_map"] < experiment_scaling.GATE
    top = worlds[4]
    assert all(r["n_tp"] == 512 and r["err_tp"] < experiment_scaling.GATE
               for r in top)
    assert max(r["tp_temp_bytes"] for r in top) < worlds[1][0][
        "tp1_temp_bytes"]
    assert "scaling OK" in capsys.readouterr().out


def test_scaling_driver_raises_when_a_rank_fails():
    from lqp_py_tpu_torch.parallel.launch import LaunchError
    with pytest.raises(LaunchError, match="rank"):
        experiment_scaling.main(["--device", "cpu", "--nproc", "2",
                                 "--backend", "no-such-backend",
                                 "--timeout", "120"])
