"""Observability layer: the cost-attribution ledger with its MFU-loss
waterfall, the per-tensor HBM memory ledger with its peak-memory
waterfall and OOM forensics, the discrete-event critical-path engine
(slack, blame, simulated waterfall, sim-vs-analytical divergence),
ledger diffing, the analytical Chrome-trace / memory-timeline exports,
telemetry, the fleet goodput ledger (``fleetledger.py``) and the
shared structured reporter. Exports what the JAX package's
``observe/__init__.py`` exports."""

from simumax_tpu_torch.observe.critpath import (
    DependencySkeleton,
    diff_critpath,
    diverge,
)
from simumax_tpu_torch.observe.fleetledger import (
    build_fleet_explain,
    build_fleet_ledger,
    diff_fleet_reports,
    fleet_chrome_trace,
    fleet_explain_lines,
    format_fleet_diff_lines,
    slo_counterfactuals,
)
from simumax_tpu_torch.observe.ledger import (
    Ledger,
    attribution_line,
    build_waterfall,
    diff_ledgers,
)
from simumax_tpu_torch.observe.memledger import (
    MemoryLedger,
    build_memory_waterfall,
    diff_memory_ledgers,
    mem_crosscheck,
    memory_attribution_line,
    oom_forensics,
)
from simumax_tpu_torch.observe.report import Reporter, configure_reporter, get_reporter

__all__ = [
    "DependencySkeleton",
    "Ledger",
    "MemoryLedger",
    "Reporter",
    "attribution_line",
    "build_fleet_explain",
    "build_fleet_ledger",
    "build_memory_waterfall",
    "build_waterfall",
    "diff_fleet_reports",
    "fleet_chrome_trace",
    "fleet_explain_lines",
    "format_fleet_diff_lines",
    "slo_counterfactuals",
    "configure_reporter",
    "diff_critpath",
    "diff_ledgers",
    "diff_memory_ledgers",
    "diverge",
    "get_reporter",
    "mem_crosscheck",
    "memory_attribution_line",
    "oom_forensics",
]
