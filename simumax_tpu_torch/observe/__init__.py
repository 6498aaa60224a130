"""Observability layer: the cost-attribution ledger with its MFU-loss
waterfall, the per-tensor HBM memory ledger with its peak-memory
waterfall and OOM forensics, the discrete-event critical-path engine
(slack, blame, simulated waterfall, sim-vs-analytical divergence),
ledger diffing, the analytical Chrome-trace / memory-timeline exports,
telemetry, and the shared structured reporter. The JAX package's fleet
ledger waits for the port's ``fleet/``."""

from simumax_tpu_torch.observe.critpath import (
    DependencySkeleton,
    diff_critpath,
    diverge,
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
    "build_memory_waterfall",
    "build_waterfall",
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
