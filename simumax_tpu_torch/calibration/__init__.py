"""Self-calibration on the local CUDA card: :func:`calibrate_for_perf`
measures exactly the shape keys a ``PerfLLM`` estimate missed in the
efficiency tables (GEMMs, attention, the fused Adam update) and writes
them back into the live system config; :func:`calibrate_system` does the
same, re-estimates, and writes the calibrated system JSON."""

from simumax_tpu_torch.calibration.autocal import (  # noqa: F401
    calibrate_for_perf,
    calibrate_system,
)
