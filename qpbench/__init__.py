"""qpbench: the benchmark of lqp_py_tpu_torch, driven by BENCHMARK.json.

One run measures one cell (a configuration under a traffic mix) on the card:
``python3 qpbench/run.py --workload NAME --seed N --seconds S --trace 0|1``.
Every configuration, traffic mix, kind of work, solver adapter, metric and
set of limits is a file of its own under this directory, found by the name
that BENCHMARK.json (or the file that names it) gives.
"""
