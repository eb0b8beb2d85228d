"""Distribution layer over ``torch.distributed`` (counterpart of
``lqp_py_tpu.parallel``): process meshes and batch sharding ('dp'),
lock-step batch-sharded solves for every solver family, and the
column-sharded ('tp') solves of every solver family (the box ADMM in
both KKT modes), each also on the rank's blocks alone (``*_local``), and
the Experiment-2 trainer over a dp x tp mesh (``train.py``).  Ranks are
processes started by ``parallel/launch.py`` (torchrun's variables,
``env://``); ``dryrun.py`` runs the trainer and the flagship solves on a
mesh of them.
"""

from lqp_py_tpu_torch.parallel.mesh import (batch_sharding,
                                            initialize_distributed,
                                            make_mesh, mesh_group,
                                            shard_batch)
from lqp_py_tpu_torch.parallel.sharded import (batch_sharded, boxqp_sharded,
                                               solve_box_qp_shard_map,
                                               solve_box_qp_sharded)
from lqp_py_tpu_torch.parallel.tp import (lowered_tp_memory,
                                          shard_problem_tp,
                                          solve_box_qp_ip_tp,
                                          solve_box_qp_ip_tp_local,
                                          solve_box_qp_tp,
                                          solve_box_qp_tp_local,
                                          solve_qp_gen_tp,
                                          solve_qp_gen_tp_local,
                                          solve_qp_optnet_tp,
                                          solve_qp_optnet_tp_local,
                                          tp_columns)
from lqp_py_tpu_torch.parallel.train import (make_train_scan_sharded,
                                             make_train_step_sharded,
                                             shard_linear_qp)

__all__ = [
    "batch_sharding", "initialize_distributed", "make_mesh", "mesh_group",
    "shard_batch",
    "batch_sharded", "boxqp_sharded", "solve_box_qp_sharded",
    "solve_box_qp_shard_map", "lowered_tp_memory", "shard_problem_tp",
    "solve_box_qp_tp", "solve_box_qp_tp_local", "solve_qp_gen_tp",
    "solve_qp_gen_tp_local", "solve_qp_optnet_tp",
    "solve_qp_optnet_tp_local", "solve_box_qp_ip_tp",
    "solve_box_qp_ip_tp_local", "tp_columns", "make_train_step_sharded",
    "make_train_scan_sharded", "shard_linear_qp",
]
