"""Observability layer: the cost-attribution ledger with its MFU-loss
waterfall, the per-tensor HBM memory ledger with its peak-memory
waterfall and OOM forensics, ledger diffing, the analytical
Chrome-trace / memory-timeline exports, and the shared structured
reporter. The critical-path engine, the fleet ledger and telemetry of
the JAX package are not ported yet (ROADMAP.md queue A item 4)."""

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
    "Ledger",
    "MemoryLedger",
    "Reporter",
    "attribution_line",
    "build_memory_waterfall",
    "build_waterfall",
    "configure_reporter",
    "diff_ledgers",
    "diff_memory_ledgers",
    "get_reporter",
    "mem_crosscheck",
    "memory_attribution_line",
    "oom_forensics",
]
