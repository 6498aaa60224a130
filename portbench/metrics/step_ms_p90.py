"""The 90th percentile of every step interval of the window, each taken
between the CUDA events that mark the step's boundaries on the stream."""

UNIT = "ms"


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of every value, by linear interpolation
    between the two nearest ranks (rank (n - 1) q / 100, counted from 0)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    rank = (len(xs) - 1) * q / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def read(record):
    return percentile(record["intervals_ms"], 90)
