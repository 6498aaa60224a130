"""The whole step's share of the chip's peak: the ideal time of the model
FLOPs a step needs (6 x the parameters a token touches x tokens, plus
causal attention; ``portbench/work.py``) over the window's mean step time
(its wall time over its steps)."""

from portbench import work

LAYER = "training step: torchref make_fused_adam"
UNIT = "%"
MOVES = "tokens_per_s"


def read(record):
    ideal_s = work.model_ideal_s(record["model"], record["mbs"], record["seq"], record["linear"])
    mean_step_s = record["window_s"] / record["steps"]
    return 100.0 * ideal_s / mean_step_s
