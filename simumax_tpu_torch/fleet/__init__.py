"""Fleet-scale goodput simulation: N jobs sharing the pod fleet (the
JAX package's docs/fleet.md). ``trace`` defines the input schema,
``sim`` the scheduler walk with cross-job replay amortization, whose
lockstep costing replays on the card (``csrc/replay.cu``), ``report``
the payload + rendering. Exports what the JAX package's
``fleet/__init__.py`` exports."""

from simumax_tpu_torch.fleet.report import (
    build_fleet_report,
    fleet_decision_lines,
    fleet_report_lines,
)
from simumax_tpu_torch.fleet.sim import (
    FleetSimulator,
    TemplateRuntime,
    elastic_goodput_walk,
    simulate_fleet,
)
from simumax_tpu_torch.fleet.trace import (
    FleetSpec,
    FleetTrace,
    JobSpec,
    TemplateSpec,
)

__all__ = [
    "FleetTrace",
    "FleetSpec",
    "TemplateSpec",
    "JobSpec",
    "FleetSimulator",
    "TemplateRuntime",
    "simulate_fleet",
    "elastic_goodput_walk",
    "build_fleet_report",
    "fleet_decision_lines",
    "fleet_report_lines",
]
