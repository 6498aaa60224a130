"""Reading the latent-attention MoE model's spans from a traced run's
exported trace: device time a step in ``mla_proj`` and ``shared_expert``
(inside ``gemm``) and in ``route`` (inside ``moe_dispatch``), beside the
families and the spans that :mod:`portbench.spans` reads.

The program (``simumax_tpu_torch/torchref/mla_moe_model.py``) writes
``mla_proj`` around latent attention's three projections (``q_proj``,
``kv_a_proj_with_mqa``, ``kv_b_proj``), ``shared_expert`` around the shared
experts' two products, and ``route`` around the float32 router product,
the sigmoid route kernel and the held experts' index. A device event takes
the innermost of :data:`REGIONS` around the host call that launched it,
by :func:`spans.host_regions` (a backward kernel through its forward op's
sequence number). The reading checks itself as :func:`spans.matches`
does: the new spans and those of :data:`spans.GEMM_PARTS` folded back into
``gemm``, ``route`` into ``moe_dispatch``, each family within
:data:`spans.TOLERANCE` of the run's own reading, or nothing is read.
Where the program writes none of these spans (a program that predates
them) every region reads 0 and a reader finds nothing.
"""

from __future__ import annotations

import functools
import json
import math
import os
from collections import defaultdict
from typing import Dict, List, Optional

from portbench import spans, trace

#: the new spans, by the family they nest in
PARTS = {"mla_proj": "gemm", "shared_expert": "gemm", "route": "moe_dispatch"}
#: what a device event is attributed to
REGIONS = spans.REGIONS + tuple(PARTS)


def read_events(events: List[dict]) -> Optional[Dict]:
    """Device ms a step by region of one profiled window (only device
    events after its mark count): {"steps", "region_ms"}; None where the
    window holds no ``step`` span or no device event after its mark."""
    steps = len(spans._spans_named(events, spans.STEP))
    events = trace.after_mark(events)
    kernels = trace.device_events(events)
    if not steps or not kernels:
        return None
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    tied = [launches.get(k.get("args", {}).get("correlation")) for k in kernels]
    regions = iter(spans.host_regions(events, [(e["tid"], e["ts"]) for e in tied
                                               if e is not None], REGIONS))
    region_ms: Dict[str, float] = defaultdict(float)
    for k, launch in zip(kernels, tied):
        region = next(regions) if launch is not None else spans._by_name(k["name"])
        region_ms[region] += k.get("dur", 0.0) / 1e3 / steps
    return {"steps": steps, "region_ms": dict(region_ms)}


def matches(got: Dict, family_ms: Dict[str, float],
            tolerance: float = spans.TOLERANCE) -> bool:
    """Whether ``got``'s device ms, every span folded back into its
    family, equal ``family_ms`` family by family and in total, each within
    ``tolerance`` of its size."""
    folded: Dict[str, float] = defaultdict(float)
    for region, ms in got["region_ms"].items():
        family = PARTS.get(region, "gemm" if region in spans.GEMM_PARTS else region)
        folded[family] += ms
    pairs = [(folded.get(f, 0.0), family_ms.get(f, 0.0)) for f in set(folded) | set(family_ms)]
    pairs.append((sum(folded.values()), sum(family_ms.values())))
    return all(math.isclose(a, b, rel_tol=tolerance, abs_tol=1e-9) for a, b in pairs)


@functools.lru_cache(maxsize=1)
def _read_file(path: str, _mtime_ns: int, _size: int) -> Optional[Dict]:
    with open(path) as f:
        events = json.load(f)
    return read_events(events["traceEvents"] if isinstance(events, dict) else events)


def read(record: Dict, bench_dir: str = spans.BENCH_DIR,
         trace_dir: str = spans.TRACE_DIR) -> Optional[Dict]:
    """:func:`read_events` of the traced run's trace (found as
    :func:`spans.trace_path` finds it), if it reads what the run's own
    family reading does (:func:`matches`); None otherwise, and for a run
    with no trace."""
    family_ms = (record.get("traced") or {}).get("family_ms")
    if not family_ms:
        return None
    path = spans.trace_path(record["cell"], bench_dir, trace_dir)
    if path is None:
        return None
    st = os.stat(path)
    got = _read_file(path, st.st_mtime_ns, st.st_size)
    if got is None or not matches(got, family_ms):
        return None
    return got


def region_ms(record: Dict, region: str) -> float:
    """Device ms a step under ``region`` in the traced run, 0 where it
    reads nothing."""
    return ((read(record) or {}).get("region_ms") or {}).get(region, 0.0)
