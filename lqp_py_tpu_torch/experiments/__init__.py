"""The port's experiment drivers: each runs as
``python -m lqp_py_tpu_torch.experiments.<name>`` (on the card by default,
``--device cpu`` on the CPU) and writes the JAX driver's artifact schema
under the same stem with ``_torch`` before the extension."""
