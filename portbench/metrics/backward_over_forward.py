"""The device time, a step, of the kernels launched inside the training
step's ``backward`` span over that of those launched inside its
``forward`` span (``portbench/spans.py``): the backward's kernels count
whichever thread launched them."""

from portbench import spans

LAYER = "training step: torchref make_fused_adam"
UNIT = "x"
MOVES = "tokens_per_s"


def read(record):
    phase_ms = (spans.read(record) or {}).get("phase_ms") or {}
    if phase_ms.get("forward", 0.0) <= 0:
        return None
    return phase_ms["backward"] / phase_ms["forward"]
