"""Self-calibration on the local CUDA card: :func:`calibrate_for_perf`
measures exactly the shape keys a ``PerfLLM`` estimate missed in the
efficiency tables (GEMMs, attention, the fused Adam update) and writes
them back into the live system config."""

from simumax_tpu_torch.calibration.autocal import calibrate_for_perf  # noqa: F401
