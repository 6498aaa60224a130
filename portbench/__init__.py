"""The benchmark of ``simumax_tpu_torch``: its training step at published
widths on one H100 (``run.py``), held to a plain reference (``reference.py``)."""
