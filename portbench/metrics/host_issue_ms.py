"""The host's time to issue a training step: the mean duration of the
program's ``step`` span over the profiled steps (the host's clock, under
the profiler; the step returns before the card finishes its work unless
the card's queue is full; ``portbench/spans.py``)."""

from portbench import spans

LAYER = "training step: torchref make_fused_adam"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(record):
    got = spans.read(record)
    return None if got is None else got["step_host_ms"]
