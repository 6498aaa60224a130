"""The discrete-event simulator: a copy of the JAX package's
``simulator/`` (engine, memory, trace, schedule, reduce, runner, plot,
faults, and the batched scenario replay, whose XLA program is the CUDA
kernel ``csrc/replay.cu`` here)."""

from simumax_tpu_torch.simulator.faults import (  # noqa: F401
    CheckpointSpec,
    FaultEvent,
    FaultScenario,
    analyze_faults,
    predict_goodput,
)
from simumax_tpu_torch.simulator.runner import run_simulation  # noqa: F401
