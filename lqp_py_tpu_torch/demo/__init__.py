"""The port's demos: each runs as ``python -m lqp_py_tpu_torch.demo.<name>``
(on the card by default, ``--device cpu`` on the CPU)."""
