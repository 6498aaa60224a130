"""The discrete-event simulator: a copy of the JAX package's
``simulator/`` (engine, memory, trace, schedule, reduce, runner, plot).
The fault model (``faults.py``) and the batched replay are not ported
yet (ROADMAP.md queue A items 4 and 7)."""

from simumax_tpu_torch.simulator.runner import run_simulation  # noqa: F401
