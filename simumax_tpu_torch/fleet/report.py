"""Fleet report assembly + human rendering (docs/fleet.md).

The payload (schema ``simumax-fleet-v1``) is **serving-invariant**:
it depends only on the trace and the elastic toggle, never on the
costing mode (``naive``), the worker count, or cache state — the
bench's bit-identity oracle and the serial==parallel test compare
whole payloads. Replay-cache accounting lives on
``FleetSimulator.stats`` / the telemetry registry instead.
"""

from __future__ import annotations

from typing import Any, Dict, List


def build_fleet_report(sim) -> Dict[str, Any]:
    """Assemble the payload from a finished
    :class:`~simumax_tpu_torch.fleet.sim.FleetSimulator` walk."""
    jobs: List[Dict[str, Any]] = []
    useful_chip_s = wall_chip_s = 0.0
    slo_total = slo_attained = 0
    makespan = 0.0
    for job in sim._jobs:
        spec = job.spec
        tpl = sim._runtimes[spec.template]
        rec: Dict[str, Any] = {
            "name": spec.name,
            "template": spec.template,
            "chips": tpl.world_size,
            "chips_final": len(job.live_ranks) or tpl.world_size,
            "priority": spec.priority,
            "spot": spec.spot,
            "arrival_s": spec.arrival_s,
            "admitted_s": job.admitted_s,
            "queue_wait_s": job.queue_wait_s,
            "completed_s": job.completed_s,
            "state": job.state,
            "suspensions": job.n_suspensions,
            "reshapes": len(job.reshapes),
            "report": job.report,
        }
        if spec.slo_goodput is not None:
            rec["slo_goodput"] = spec.slo_goodput
            attained = (
                job.report is not None
                and job.state == "done"
                and job.report["goodput"] >= spec.slo_goodput
            )
            rec["slo_attained"] = attained
            slo_total += 1
            slo_attained += int(attained)
        jobs.append(rec)
        if job.report is not None and job.state == "done":
            useful_chip_s += (
                job.report["useful_time_s"] * tpl.world_size
            )
            wall_chip_s += (
                job.report["wall_time_s"] * tpl.world_size
            )
            makespan = max(makespan, job.completed_s or 0.0)
    total_chips = sim.fleet.total_chips
    templates = {
        key: {
            "world_size": rt.world_size,
            "replica_chips": rt.replica_chips,
            "granularity": rt.granularity,
            "healthy_step_s": rt.healthy_step_s,
            "link_headroom_pct": rt.link_headroom_pct(),
            "jobs": sum(
                1 for j in sim._jobs if j.spec.template == key
            ),
        }
        for key, rt in sorted(sim._runtimes.items())
    }
    return {
        "schema": "simumax-fleet-v1",
        "elastic": sim.elastic,
        "policy": sim.policy,
        "total_chips": total_chips,
        "n_jobs": len(sim._jobs),
        "n_templates": len(sim._runtimes),
        "makespan_s": makespan,
        #: chip-second-weighted goodput over completed jobs: the
        #: fleet-level fraction of occupied chip time spent training
        "fleet_goodput": (
            useful_chip_s / wall_chip_s if wall_chip_s else 1.0
        ),
        #: occupied chip-seconds over the fleet's capacity x makespan
        "chip_utilization": (
            wall_chip_s / (total_chips * makespan)
            if makespan > 0 else 0.0
        ),
        "slo": {
            "total": slo_total,
            "attained": slo_attained,
            "fraction": (
                slo_attained / slo_total if slo_total else 1.0
            ),
        },
        "templates": templates,
        "jobs": jobs,
        "decisions": list(sim.decisions),
    }


def fleet_report_lines(report: Dict[str, Any],
                       top_decisions: int = 12) -> List[str]:
    """Human rendering: the fleet headline, per-template summary,
    per-job table, and the head of the decision timeline."""
    lines = [
        f"== fleet: {report['n_jobs']} jobs over "
        f"{report['n_templates']} templates on "
        f"{report['total_chips']} chips "
        f"(policy {report['policy']}"
        f"{', elastic' if report['elastic'] else ''}) ==",
        f"  fleet goodput {100.0 * report['fleet_goodput']:.2f}%  "
        f"chip utilization "
        f"{100.0 * report['chip_utilization']:.2f}%  "
        f"makespan {report['makespan_s']:.1f} s",
    ]
    slo = report["slo"]
    if slo["total"]:
        lines.append(
            f"  SLO attainment {slo['attained']}/{slo['total']} "
            f"({100.0 * slo['fraction']:.1f}%)"
        )
    for name, t in report["templates"].items():
        lines.append(
            f"  template {name}: {t['jobs']} jobs x "
            f"{t['world_size']} chips, healthy step "
            f"{t['healthy_step_s'] * 1e3:.1f} ms, link headroom "
            f"{t['link_headroom_pct']:.2f}%"
        )
    width = max(len(j["name"]) for j in report["jobs"])
    for j in report["jobs"]:
        g = j["report"]["goodput"] if j["report"] else float("nan")
        slo_mark = ""
        if "slo_attained" in j:
            slo_mark = "  SLO ok" if j["slo_attained"] \
                else "  SLO MISS"
        extras = []
        if j["queue_wait_s"]:
            extras.append(f"waited {j['queue_wait_s']:.0f}s")
        if j["suspensions"]:
            extras.append(f"{j['suspensions']} suspensions")
        if j["reshapes"]:
            extras.append(
                f"{j['reshapes']} reshapes -> "
                f"{j['chips_final']} chips"
            )
        lines.append(
            f"  {j['name']:<{width}}  {j['template']:<16} "
            f"goodput {100.0 * g:6.2f}%{slo_mark}"
            + ("  (" + ", ".join(extras) + ")" if extras else "")
        )
    decs = report["decisions"]
    if report.get("explain"):
        lines.extend(fleet_decision_lines(report))
        return lines
    lines.append(f"  -- decisions ({len(decs)} total) --")
    for d in decs[:top_decisions]:
        extra = {
            k: v for k, v in d.items()
            if k not in ("t_s", "event", "job")
        }
        who = f" {d['job']}" if "job" in d else ""
        lines.append(
            f"  t={d['t_s']:>10.1f}s  {d['event']:<10}{who}"
            + (f"  {extra}" if extra else "")
        )
    if len(decs) > top_decisions:
        lines.append(f"  ... {len(decs) - top_decisions} more")
    return lines


def fleet_decision_lines(report: Dict[str, Any],
                         top_per_event: int = 6) -> List[str]:
    """Decision timeline grouped by event kind, each group annotated
    with the goodput cost the explain ledger attributes to its
    causing events — the expensive tail the flat top-12 list
    truncates. Needs the report's ``explain`` payload (satellite of
    the fleet forensics PR; ``observe/fleetledger.py``)."""
    explain = report.get("explain") or {}
    ledger = explain.get("ledger") or {}
    #: causing-event id -> loss chip-seconds (useful time excluded)
    cause_cost = {
        r["cause"]: r["chip_s"] - r["buckets"].get("useful_train", 0.0)
        for r in ledger.get("causes", [])
        if r["cause"] != "useful"
    }
    groups: Dict[str, List[dict]] = {}
    order: List[str] = []
    for d in report["decisions"]:
        if d["event"] not in groups:
            order.append(d["event"])
        groups.setdefault(d["event"], []).append(d)
    lines = [
        f"  -- decisions ({len(report['decisions'])} total, "
        f"grouped by event) --"
    ]
    for event in order:
        ds = groups[event]
        ev_causes = {d["cause"] for d in ds if "cause" in d}
        cost = sum(cause_cost.get(c, 0.0) for c in ev_causes)
        head = f"  {event} x{len(ds)}"
        if cost > 0.0:
            head += f"  [{cost:.1f} chip-s goodput loss attributed]"
        lines.append(head)
        # costliest decisions first inside each group; ties by time
        ds_ranked = sorted(
            ds, key=lambda d: (-cause_cost.get(d.get("cause", ""),
                                              0.0), d["t_s"]),
        )
        for d in ds_ranked[:top_per_event]:
            extra = {
                k: v for k, v in d.items()
                if k not in ("t_s", "event", "job", "cause")
            }
            who = f" {d['job']}" if "job" in d else ""
            c = d.get("cause")
            tag = ""
            if c is not None and cause_cost.get(c, 0.0) > 0.0:
                tag = f"  [{c}: {cause_cost[c]:.1f} chip-s]"
            lines.append(
                f"    t={d['t_s']:>10.1f}s {who or ' -'}"
                + (f"  {extra}" if extra else "") + tag
            )
        if len(ds) > top_per_event:
            lines.append(f"    ... {len(ds) - top_per_event} more")
    return lines


__all__ = ["build_fleet_report", "fleet_decision_lines",
           "fleet_report_lines"]
