"""Every token of the window's steps over the window's wall time (the host
clock, the window ended by a synchronize)."""

UNIT = "tokens/s"


def read(record):
    return record["steps"] * record["tokens_per_step"] / record["window_s"]
