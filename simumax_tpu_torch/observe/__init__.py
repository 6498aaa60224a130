"""Observability layer: the shared structured reporter. The ledgers,
critical-path engine and telemetry of the JAX package are not ported
yet (see ROADMAP.md)."""

from simumax_tpu_torch.observe.report import Reporter, configure_reporter, get_reporter

__all__ = ["Reporter", "configure_reporter", "get_reporter"]
