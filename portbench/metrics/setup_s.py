"""Seconds from the process's start to the first timed step: import, the
weights made on the card, the kernel libraries loaded (and built, in a
checkout's first run), the compared steps that warm every shape."""

UNIT = "s"


def read(record):
    return record["setup_s"]
