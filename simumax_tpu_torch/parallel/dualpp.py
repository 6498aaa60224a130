"""Dual-pipeline (DualPipe-style) analytical helper.

Reference: ``pp_simu/utils.py:4-162`` (``duration_dualpp``,
``perf_dualpp``, ``cal_cost``) — a standalone closed-form estimator for
bidirectional pipeline schedules where forward and backward chunks of
the two directions overlap, and MoE dispatch/combine all-to-all hides
under the opposite direction's compute.

Phase naming follows the DualPipe paper: F = forward chunk, B = full
backward (dgrad+wgrad), W = weight-grad-only portion; the pipeline
bubble is (pp/2 - 1) * (F&B + B - 3W) with F&B the overlapped
forward+backward duration.

Copy of the JAX package's ``parallel/dualpp.py``, unchanged. Where
matplotlib is not installed, ``save_path`` cannot render the timeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class DualPPPhase:
    """Per-microbatch, per-stage phase times (seconds)."""

    fwd: float
    bwd_act: float
    bwd_w: float
    comm_exposed: float = 0.0  # a2a / p2p not hidden by overlap

    @property
    def bwd(self) -> float:
        return self.bwd_act + self.bwd_w

    @property
    def fb_overlap(self) -> float:
        """Duration of an overlapped F&B cell: compute serializes on one
        core, but each direction's exposed comm hides under the other's
        compute."""
        comp = self.fwd + self.bwd
        return max(comp, self.comm_exposed * 2)


def duration_dualpp(pp: int, mbc: int, phase: DualPPPhase,
                    fb_duration: "float | None" = None) -> Dict[str, float]:
    """Closed-form DualPipe iteration duration for ``mbc`` microbatches
    over ``pp`` stages (pp even; each rank hosts two chunks, one per
    direction). ``fb_duration`` overrides the F&B cell length with the
    list-scheduled overlap (``schedule_fb_cell``) when available
    (``None`` = closed-form fallback; an explicit 0.0 is honored)."""
    assert pp % 2 == 0, "DualPipe requires an even number of stages"
    f, b, w = phase.fwd, phase.bwd, phase.bwd_w
    steady = mbc * (f + b) / 1.0  # per-rank total compute work
    fb = phase.fb_overlap if fb_duration is None else fb_duration
    bubble = (pp / 2 - 1) * (fb + b - 3 * w)
    bubble = max(bubble, 0.0)
    total = steady + bubble + phase.comm_exposed * pp
    return {"total": total, "bubble": bubble, "steady": steady}


def cal_cost(perf, stage: int = 0) -> DualPPPhase:
    """Extract DualPP phase times from an estimated ``PerfLLM``
    (reference ``cal_cost``): per-microbatch fwd/bwd split plus the
    exposed a2a/p2p that DualPipe would overlap."""
    chunks = perf.stage_chunks(stage)
    fwd = sum(c.cost_info.compute.fwd for c in chunks)
    bwd_act = sum(
        c.cost_info.compute.bwd_act + c.cost_info.recompute_time
        for c in chunks
    )
    bwd_w = sum(c.cost_info.compute.bwd_w for c in chunks)
    comm = sum(c.cost_info.net_exposed.total for c in chunks)
    return DualPPPhase(fwd=fwd, bwd_act=bwd_act, bwd_w=bwd_w,
                       comm_exposed=comm)


@dataclass
class ComponentTimes:
    """Per-microbatch component times for one F&B cell (seconds)."""

    attn_f: float
    mlp_f: float
    attn_bd: float  # attention dgrad
    attn_w: float
    mlp_bd: float
    mlp_w: float
    dispatch: float = 0.0  # MoE a2a (per direction)
    combine: float = 0.0
    #: exposed non-a2a comm (tp ag/rs, cp, ...) per direction — kept on
    #: the comm lane so comm-bound configs still expose it
    other_f: float = 0.0
    other_b: float = 0.0


def schedule_fb_cell(ct: ComponentTimes) -> Dict[str, object]:
    """Overlapped F&B cell: a dependency-driven two-lane list schedule
    (compute serialized on the MXU lane, a2a serialized on the ICI
    lane), the mechanism DualPipe uses to hide MoE dispatch/combine of
    one direction under the other direction's compute (reference
    ``pp_simu/utils.py::cal_FandB``; here a generic scheduler instead
    of a hand-rolled interval list).

    Chains: F = attn_f -> dispatch_f -> mlp_f -> combine_f;
    B = combine_b -> mlp_bd -> dispatch_b -> attn_bd -> {attn_w, mlp_w}.
    Returns total duration + per-task (start, end) intervals.
    """
    dur = {
        "attn_F": ct.attn_f, "mlp_F": ct.mlp_f,
        "attn_B": ct.attn_bd, "mlp_B": ct.mlp_bd,
        "attn_W": ct.attn_w, "mlp_W": ct.mlp_w,
        "dispatch_F": ct.dispatch, "combine_F": ct.combine,
        "dispatch_B": ct.dispatch, "combine_B": ct.combine,
        "other_F": ct.other_f, "other_B": ct.other_b,
    }
    deps = {
        "attn_F": [], "dispatch_F": ["attn_F"],
        "mlp_F": ["dispatch_F"], "combine_F": ["mlp_F"],
        "combine_B": [], "mlp_B": ["combine_B"],
        "dispatch_B": ["mlp_B"], "attn_B": ["dispatch_B"],
        "attn_W": ["attn_B"], "mlp_W": ["mlp_B"],
        "other_F": ["attn_F"], "other_B": ["combine_B"],
    }
    lane_of = {
        t: ("comp" if t.startswith(("attn", "mlp")) else "comm")
        for t in dur
    }
    # priority interleaves the two directions so each lane always has
    # work from the opposite chain to hide under
    prio = ["attn_F", "combine_B", "dispatch_F", "other_B", "mlp_B",
            "mlp_F", "other_F", "dispatch_B", "combine_F", "attn_B",
            "mlp_W", "attn_W"]
    end: Dict[str, float] = {}
    start: Dict[str, float] = {}
    lane_free = {"comp": 0.0, "comm": 0.0}
    # zero-duration tasks are scheduled too: they cost nothing but keep
    # transitive dependencies intact (a zero a2a still orders mlp_F
    # after attn_F)
    pending = list(prio)
    while pending:
        progressed = False
        for t in list(pending):
            if any(d not in end for d in deps[t]):
                continue
            lane = lane_of[t]
            dep_ready = max(
                (end[d] for d in deps[t]), default=0.0
            )
            start[t] = max(lane_free[lane], dep_ready)
            end[t] = start[t] + dur[t]
            lane_free[lane] = end[t]
            pending.remove(t)
            progressed = True
        assert progressed, f"cyclic deps in fb cell: {pending}"
    total = max(end.values(), default=0.0)
    return {
        "total": total,
        "intervals": {t: (start[t], end[t]) for t in end},
        "lanes": lane_of,
    }


def cell_components(perf, stage: int = 0) -> ComponentTimes:
    """Extract per-microbatch component times from an estimated
    ``PerfLLM``: attention vs MLP/expert compute per phase, MoE
    dispatch/combine a2a from the Permutation collective calls."""
    attn = [0.0, 0.0, 0.0]  # fwd, bwd_act(+recompute), bwd_w
    mlp = [0.0, 0.0, 0.0]
    a2a = [0.0, 0.0]  # dispatch, combine (fwd direction)
    a2a_bwd = 0.0
    net = [0.0, 0.0]  # exposed net: fwd, bwd(act+w)
    for chunk in perf.stage_chunks(stage):
        for leaf in chunk.called_leaves():
            path = leaf.path_name()
            ci = leaf.cost_info
            dst = (
                attn
                if "attention" in path or path.endswith(("rope", "rotary"))
                else mlp
            )
            dst[0] += ci.compute.fwd
            # recompute_time = replayed fwd compute + fwd net; keep
            # only the compute part on the comp lane and put the
            # replayed fwd collectives on the comm lane with the other
            # backward-phase traffic (they run during the backward)
            replay_net = min(ci.recompute_time, ci.net_exposed.fwd)
            dst[1] += ci.compute.bwd_act + max(
                ci.recompute_time - ci.net_exposed.fwd, 0.0
            )
            dst[2] += ci.compute.bwd_w
            net[0] += ci.net_exposed.fwd
            net[1] += ci.net_exposed.bwd_act + ci.net_exposed.bwd_w + replay_net
            tail = path.rsplit(".", 1)[-1]
            for call in leaf.collective_calls:
                if call.op == "all2all" and call.dim in ("ep", "etp"):
                    if call.phase == "fwd":
                        idx = 1 if tail in ("combine", "unpermutation") else 0
                        a2a[idx] += call.exposed_time
                    else:
                        a2a_bwd += call.exposed_time
    return ComponentTimes(
        attn_f=attn[0], mlp_f=mlp[0], attn_bd=attn[1], attn_w=attn[2],
        mlp_bd=mlp[1], mlp_w=mlp[2], dispatch=a2a[0], combine=a2a[1],
        other_f=max(net[0] - a2a[0] - a2a[1], 0.0),
        other_b=max(net[1] - a2a_bwd, 0.0),
    )


def plot_fb_cell(cell: Dict[str, object], save_path: str) -> str:
    """Render the overlapped F&B cell as a two-lane interval chart
    (reference ``show_overlap_all2all``); needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    intervals: Dict[str, tuple] = cell["intervals"]  # type: ignore
    lanes: Dict[str, str] = cell["lanes"]  # type: ignore
    fig, ax = plt.subplots(figsize=(10, 2.2))
    y = {"comp": 1.0, "comm": 0.0}
    for t, (s, e) in intervals.items():
        if e - s <= 0:
            continue  # zero-duration placeholder tasks
        lane = lanes[t]
        color = "#4878a8" if lane == "comp" else "#c44e52"
        ax.barh(y[lane], e - s, left=s, height=0.6, color=color,
                edgecolor="white")
        ax.text((s + e) / 2, y[lane], t, ha="center", va="center",
                fontsize=7, color="white")
    ax.set_yticks([0.0, 1.0])
    ax.set_yticklabels(["ICI a2a", "compute"])
    ax.set_xlabel("time (s)")
    ax.set_title("DualPipe F&B cell overlap")
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def _compare_to_baseline(perf, dual_total: float) -> Dict[str, float]:
    """Shared 1F1B-vs-DualPipe comparison tail: add the schedule-external
    terms (DP comm, optimizer) and the SAME straggler inflation the
    baseline iter_time carries, so the speedup compares like with like."""
    base = perf.analysis_cost()
    extra = base["dp_comm"]["total"] + base["optim_time"]
    dual_iter = (dual_total + extra) * base["straggle_ratio"]
    speedup = base["iter_time"] / dual_iter if dual_iter > 0 else 0.0
    return {
        "dualpp_iter_time": dual_iter,
        "baseline_iter_time": base["iter_time"],
        "baseline_bubble": base["bubble_time"],
        "speedup": speedup,
        "projected_mfu": base["mfu"] * speedup,
    }


def analyze(perf, save_path: str = None) -> Dict[str, object]:
    """Full per-rank DualPipe projection for an estimated ``PerfLLM``
    (beyond the reference, whose DualPipe support is the standalone
    closed-form helper only): rank r hosts TWO stage chunks — stage r of
    the forward direction and stage pp-1-r of the reverse direction —
    so parameters double per rank and each direction contributes half
    the microbatches. Peak memory per rank uses the DualPipe paper's
    in-flight bound of pp+1 microbatch activations, charged
    conservatively at the bigger chunk's per-microbatch cache.
    """
    from simumax_tpu_torch.core.config import _require

    st = perf.strategy
    pp, mbc = st.pp_size, st.micro_batch_num
    _require(pp % 2 == 0 and pp > 1, "DualPipe requires even pp >= 2")
    _require(st.vp_size == 1, "DualPipe and VPP interleaving are exclusive")
    mem = perf.analysis_mem()
    stages = mem["stages"]
    # rank r and its mirror pp-1-r host the identical stage pair, so
    # compute each pair once and mirror the row
    pair_rows: Dict[int, dict] = {}
    cells: Dict[int, dict] = {}
    for r in range(pp // 2):
        m = pp - 1 - r
        ph_a, ph_b = cal_cost(perf, r), cal_cost(perf, m)
        phase = DualPPPhase(
            fwd=(ph_a.fwd + ph_b.fwd) / 2,
            bwd_act=(ph_a.bwd_act + ph_b.bwd_act) / 2,
            bwd_w=(ph_a.bwd_w + ph_b.bwd_w) / 2,
            comm_exposed=(ph_a.comm_exposed + ph_b.comm_exposed) / 2,
        )
        cells[r] = schedule_fb_cell(cell_components(perf, r))
        fb = (
            cells[r]["total"]
            + schedule_fb_cell(cell_components(perf, m))["total"]
        ) / 2
        d = duration_dualpp(pp, mbc, phase, fb_duration=fb)
        model_bytes = (
            stages[r]["model_bytes"] + stages[m]["model_bytes"]
        )
        act_mb = max(
            stages[r]["act_cache_per_microbatch_bytes"],
            stages[m]["act_cache_per_microbatch_bytes"],
        )
        replay = max(
            stages[r]["replay_peak_bytes"], stages[m]["replay_peak_bytes"]
        )
        # baseline convention (perf.analysis_mem): live-1 full caches +
        # the replay peak, which already includes the active
        # microbatch's cache; DualPipe's in-flight bound is pp+1,
        # capped by the microbatches that actually exist
        live = min(mbc, pp + 1)
        peak = model_bytes + max(live - 1, 0) * act_mb + replay
        pair_rows[r] = {
            "total": d["total"], "bubble": d["bubble"],
            "model_bytes": model_bytes,
            "peak_bytes": peak, "peak_gib": peak / 2**30,
        }
    rows = []
    for r in range(pp):
        pair = pair_rows[min(r, pp - 1 - r)]
        rows.append({"rank": r, "stages": (r, pp - 1 - r), **pair})
    worst_total = max(p["total"] for p in pair_rows.values())
    if save_path:
        plot_fb_cell(cells[0], save_path)
    out = _compare_to_baseline(perf, worst_total)
    out.update({
        "ranks": rows,
        "max_peak_bytes": max(r["peak_bytes"] for r in rows),
        "max_peak_gib": max(r["peak_gib"] for r in rows),
        "baseline_peak_gib": mem["max_peak_gib"],
    })
    return out


def perf_dualpp(perf, stage: int = 0,
                save_path: str = None) -> Dict[str, float]:
    """Compare a DualPipe schedule against the estimated 1F1B result
    for the same model/strategy; returns durations + projected MFU.
    ``save_path`` renders the overlapped F&B cell timeline to PNG
    (reference's overlap plot)."""
    st = perf.strategy
    assert st.pp_size % 2 == 0, "DualPipe needs even pp"
    phase = cal_cost(perf, stage)
    cell = schedule_fb_cell(cell_components(perf, stage))
    if save_path:
        plot_fb_cell(cell, save_path)
    dual = duration_dualpp(st.pp_size, st.micro_batch_num, phase,
                           fb_duration=cell["total"])
    out = _compare_to_baseline(perf, dual["total"])
    out["dualpp_bubble"] = dual["bubble"]
    return out
