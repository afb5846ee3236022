"""Runnable examples of the port; counterparts of the reference's
``examples/``.  Each runs as ``python -m repro_torch.examples.<name>``."""
