"""Per-stage job generators for the event simulator (L5).

Reference: ``simumax/core/transformer/pipeline_schedule.py``
(``PpSchedule.prefill_batch:717-959`` non-interleaved 1F1B,
``OptimizerSimulator:30-87``) + the per-leaf job factories scattered
through the reference's leaf modules (``prefill_fwd/prefill_bwd``).

Redesign: leaves carry no job-construction code — the generator walks
each chunk's called leaves and replays their recorded cost/activation
info as engine requests, with the memory tracker driven inline. One
simulated rank per PP stage (the reference's ``merge_lanes`` mode):
intra-stage collectives (tp/cp/ep/etp) are charged as local comm-lane
time; PP p2p and the optimizer barrier are true cross-rank rendezvous.

Copy of the JAX package's ``simulator/schedule.py`` with its import
paths changed.
"""

from __future__ import annotations

from typing import Generator, List, Optional

from simumax_tpu_torch.core.utils import dp_comm_buckets
from simumax_tpu_torch.parallel.pipeline import one_f_one_b_order
from simumax_tpu_torch.simulator.memory import SimuMemoryTracker


def _leaf_calls(leaf, phase: str, point: str):
    return [
        c for c in leaf.collective_calls
        if c.phase == phase and c.point == point and c.exposed_time > 0
    ]


class StageProcess:
    """Builds the generator coroutine for one PP stage."""

    #: model-equivalence pin (docs/simulation.md "Blocking-send
    #: model"): when True, non-interleaved blocking 1F1B issues its
    #: steady-state sends as true Megatron batched isend/irecv pairs
    #: (engine ``sendrecv``, the send batched with the next op's recv
    #: — ``send_forward_recv_backward`` semantics) instead of the
    #: default async-send + sender transfer-stall approximation. On a
    #: symmetric schedule the two are timing-identical; the regression
    #: test ``tests/test_critpath.py::TestSteadyStateSendrecvParity``
    #: pins that equivalence across the blocking parity grid, which is
    #: why the lean default model is sound.
    _steady_sendrecv = False

    def __init__(
        self,
        perf,
        stage: int,
        tracker: Optional[SimuMemoryTracker] = None,
        granularity: str = "leaf",
        rank: Optional[int] = None,
        perturb: float = 1.0,
        groups: Optional[dict] = None,
        dp_cp_group: Optional[list] = None,
        bucket_groups: Optional[dict] = None,
        neighbor_map: Optional[dict] = None,
        barrier_group: Optional[list] = None,
    ):
        self.perf = perf
        self.stage = stage
        self.st = perf.strategy
        self.tracker = tracker
        self.granularity = granularity
        self.chunks = perf.stage_chunks(stage)
        self.pp = self.st.pp_size
        #: world-rank mode: this process IS global rank ``rank``; exposed
        #: intra-stage collectives become true rendezvous among the
        #: rank's groups, and ``perturb`` scales its compute (straggler
        #: injection). Under symmetry reduction ``rank`` is an *engine*
        #: rank (one per class) and ``groups`` / ``neighbor_map`` /
        #: ``barrier_group`` arrive pre-mapped onto class reps — the
        #: process itself never needs global coordinates then.
        self.rank = rank
        self.perturb = perturb
        self._groups = groups or {}
        self._dp_cp_group = dp_cp_group
        #: pre-computed dp_cp/edp grad-stream rendezvous groups (the
        #: runner builds them once for the whole world — the lazy
        #: ``group_of`` fallback below is O(world) per rank, quadratic
        #: at pod scale)
        self._bucket_groups = bucket_groups or {}
        self._neighbor_map = neighbor_map
        self._barrier_group = barrier_group
        if rank is not None and not self._groups:
            from simumax_tpu_torch.parallel.mesh import group_of

            for dim in ("tp", "cp", "ep", "etp"):
                if getattr(self.st, f"{dim}_size") > 1:
                    self._groups[dim] = group_of(rank, self.st, dim)
        path = perf.ctx.path("pp")
        self.p2p_time = (
            perf.system.compute_net_op_time(
                "p2p", self.chunks[0].boundary_bytes(), path
            )
            if self.pp > 1
            else 0.0
        )
        # independent DP-comm model (NOT perf._compute_dp_time): bucket
        # plan from this stage's own params; overlap emerges from the
        # engine's async comm streams rather than a closed-form min()
        self._dp = self._dp_plan()
        self._rs_cursor = {d: 0 for d in self._dp["rs"]}
        self._grad_acc = {d: 0.0 for d in self._dp["rs"]}
        self._rs_active = False
        self._dp_groups: dict = {}

    # -- DP comm plan (independent of the analytical path) -----------------
    def _dp_plan(self) -> dict:
        """Per-stream grad reduce / param gather bucket schedules.

        Streams: dense grads over ``dp_cp``, MoE grads over ``edp`` —
        modeled as parallel comm channels (Megatron uses separate
        process groups / NCCL streams for the two).
        """
        st, sysc, perf = self.st, self.perf.system, self.perf
        dense = sum(c.param_info.dense_numel for c in self.chunks)
        moe = sum(c.param_info.moe_numel for c in self.chunks)
        g_el = 2.0 if st.grad_reduce_in_bf16 else 4.0
        p_el = st.element_size
        plan = {"rs": {}, "ag": {}, "bounds": {}, "tied": 0.0}
        specs = []
        if st.dp_size * st.cp_size > 1 and dense > 0 and st.zero_state < 3:
            specs.append(("dp_cp", dense, st.dp_size * st.cp_size))
        if st.edp_size > 1 and moe > 0 and st.zero_state < 3:
            specs.append(("edp", moe, st.edp_size))
        for dim, numel, group in specs:
            path = perf.ctx.path(dim)
            op = "reduce_scatter" if st.zero_state >= 1 else "all_reduce"
            sizes = dp_comm_buckets(numel, group)
            plan["rs"][dim] = [
                sysc.compute_net_op_time(op, nb * g_el, path) for nb in sizes
            ]
            bounds, acc = [], 0.0
            for nb in sizes:
                acc += nb
                bounds.append(acc)
            plan["bounds"][dim] = bounds
            if st.zero_state >= 1:
                plan["ag"][dim] = [
                    sysc.compute_net_op_time("all_gather", nb * p_el, path)
                    for nb in sizes
                ]
        if (
            st.pp_size > 1
            and not perf.model_config.untie_embeddings
            and self.stage in (0, self.pp - 1)
        ):
            m = perf.model_config
            emb_grad = (
                m.padded_vocab_size * m.hidden_size / st.tp_size
                * st.grad_element_size
            )
            plan["tied"] = 2 * sysc.compute_net_op_time(
                "p2p", emb_grad, perf.ctx.path("pp")
            )
        return plan

    def _dim_group(self, dim: str):
        """dp_cp / edp rendezvous group of this world rank (None in
        merged mode: the group's members are represented by one rank).
        Computed once per StageProcess; pre-mapped groups passed by the
        runner (full-world precompute or symmetry reduction) win."""
        if self.rank is None:
            return None
        if dim in self._bucket_groups:
            return self._bucket_groups[dim]
        if dim in self._dp_groups:
            return self._dp_groups[dim]
        from simumax_tpu_torch.parallel.mesh import group_of, rank_coords

        st = self.st
        if dim == "dp_cp":
            group = self._dp_cp_group
            if not group:
                mine = rank_coords(self.rank, st)
                group = sorted(
                    r for r in range(st.world_size)
                    if rank_coords(r, st)["tp"] == mine["tp"]
                    and rank_coords(r, st)["pp"] == mine["pp"]
                )
        else:
            group = group_of(self.rank, st, dim)
        self._dp_groups[dim] = group
        return group

    def _engine_rank(self) -> int:
        return self.stage if self.rank is None else self.rank

    def _async_bucket(self, dim: str, idx: int, dur: float, tag: str):
        group = self._dim_group(dim)
        peers = group if group else [self._engine_rank()]
        return (
            "async_collective", f"{tag}:{dim}", dur,
            f"{tag}_{dim}_b{idx}", list(peers),
        )

    def _grad_ready(self, leaf) -> Generator:
        """Post grad-reduce buckets whose parameters have all produced
        grads (called after each leaf backward while overlap is active)."""
        if not self._rs_active:
            return
        ready = {
            "dp_cp": leaf.param_info.dense_numel,
            "edp": leaf.param_info.moe_numel,
        }
        for dim, buckets in self._dp["rs"].items():
            self._grad_acc[dim] += ready.get(dim, 0.0)
            bounds = self._dp["bounds"][dim]
            while (
                self._rs_cursor[dim] < len(buckets)
                and self._grad_acc[dim] >= bounds[self._rs_cursor[dim]] - 1e-6
            ):
                i = self._rs_cursor[dim]
                self._rs_cursor[dim] = i + 1
                yield self._async_bucket(dim, i, buckets[i], "grad_rs")

    def _begin_rs_window(self):
        self._rs_active = True
        self._rs_cursor = {d: 0 for d in self._dp["rs"]}
        self._grad_acc = {d: 0.0 for d in self._dp["rs"]}

    def _flush_rs_window(self) -> Generator:
        """End of an overlapped backward window: post any bucket not yet
        posted (chunk-granularity walks never post inline)."""
        if not self._rs_active:
            return
        for dim, buckets in self._dp["rs"].items():
            while self._rs_cursor[dim] < len(buckets):
                i = self._rs_cursor[dim]
                self._rs_cursor[dim] = i + 1
                yield self._async_bucket(dim, i, buckets[i], "grad_rs")
        self._rs_active = False

    def _pp_stride(self) -> int:
        st = self.st
        return st.tp_size * st.cp_size * st.dp_size

    def _neighbor(self, stage: int) -> int:
        """Engine rank id of the same position at another pp stage."""
        if self.rank is None:
            return stage
        if self._neighbor_map is not None:
            return self._neighbor_map[stage]
        return self.rank + (stage - self.stage) * self._pp_stride()

    def _comm_events(self, leaf, phase: str, point: str):
        """Yield exposed-comm engine requests for one leaf phase/point:
        lumped local time in merged mode; true per-group rendezvous in
        world-rank mode. Overlapped (hidden) collective time is emitted
        as zero-advance trace spans so traces show the async comm."""
        name = leaf.path_name().split(".", 1)[-1]
        hidden = sum(
            c.time - c.exposed_time
            for c in leaf.collective_calls
            if c.phase == phase and c.point == point
            and c.time > c.exposed_time
        )
        if hidden > 0:
            yield ("trace", hidden, f"{name}.{phase}_comm_async", "comm")
        if self.rank is None:
            total = sum(c.exposed_time for c in _leaf_calls(leaf, phase, point))
            if total:
                yield ("compute", total, f"{name}.{phase}_comm", "comm")
            return
        for c in _leaf_calls(leaf, phase, point):
            group = self._groups.get(c.dim)
            if group is None:
                if c.exposed_time:
                    yield ("compute", c.exposed_time, f"{name}.{c.op}", "comm")
                continue
            yield (
                "collective",
                (c.dim, tuple(group)),
                c.exposed_time,
                f"{name}.{c.op}[{c.dim}]",
                list(group),
            )

    # -- memory helpers ----------------------------------------------------
    @staticmethod
    def _token(mb, leaf, prefix=""):
        """Cache-token id: readable leaf path for peak attribution plus
        the object id for uniqueness (two leaves may share a path name,
        and backward frees in reverse order — a shared FIFO would pop
        the wrong size)."""
        name = leaf.path_name().split(".", 1)[-1]
        return f"mb{mb}:{prefix}{name}#{id(leaf)}"

    def _alloc(self, t, nbytes, token=None, tag=""):
        if self.tracker is not None and nbytes:
            self.tracker.alloc(t, nbytes, token, tag)

    def _free(self, t, nbytes=0.0, token=None, tag=""):
        if self.tracker is not None:
            self.tracker.free(t, nbytes, token, tag)

    # -- one microbatch forward / backward ---------------------------------
    def _fwd(self, mb: int, clock: List[float], chunks=None) -> Generator:
        for chunk in (chunks if chunks is not None else self.chunks):
            if self.granularity == "chunk":
                dur = (chunk.cost_info.compute.fwd * self.perturb
                       + chunk.cost_info.net_exposed.fwd)
                t = yield ("compute", dur, f"fwd_mb{mb}", "comp")
                clock[0] = t
                self._alloc(t, chunk.act_info.cache_bytes,
                            f"mb{mb}:c{chunk.chunk_idx}", "act")
                continue
            for leaf in chunk.called_leaves():
                comp = leaf.cost_info.compute.fwd * self.perturb
                name = leaf.path_name().split(".", 1)[-1]
                for ev in self._comm_events(leaf, "fwd", "pre"):
                    t = yield ev
                    clock[0] = t
                self._alloc(clock[0], leaf.raw_act_info.fwd_temp_bytes,
                            tag="temp")
                if comp:
                    t = yield ("compute", comp, f"{name}.fwd#mb{mb}", "comp")
                    clock[0] = t
                self._free(clock[0], leaf.raw_act_info.fwd_temp_bytes,
                           tag="temp")
                if leaf.act_info.cache_bytes:
                    self._alloc(
                        clock[0], leaf.act_info.cache_bytes,
                        self._token(mb, leaf), "act",
                    )
                for ev in self._comm_events(leaf, "fwd", "post"):
                    t = yield ev
                    clock[0] = t

    def _bwd(self, mb: int, clock: List[float], chunks=None) -> Generator:
        for chunk in reversed(chunks if chunks is not None else self.chunks):
            if self.granularity == "chunk":
                dur = (
                    chunk.cost_info.compute.bwd * self.perturb
                    + chunk.cost_info.recompute_time * self.perturb
                    + chunk.cost_info.net_exposed.bwd_act
                    + chunk.cost_info.net_exposed.bwd_w
                )
                t = yield ("compute", dur, f"bwd_mb{mb}", "comp")
                clock[0] = t
                self._free(t, token=f"mb{mb}:c{chunk.chunk_idx}", tag="act")
                continue
            leaves = chunk.called_leaves()
            done = set()
            i = len(leaves) - 1
            while i >= 0:
                leaf = leaves[i]
                if id(leaf) in done:
                    i -= 1
                    continue
                seg = getattr(leaf, "recompute_segment", None)
                if leaf.in_recompute and seg is not None:
                    seg_leaves = [
                        l for l in leaves
                        if getattr(l, "recompute_segment", None) is seg
                    ]
                    # variance-tail leaves are not replayed (reference
                    # ``base_struct.py:444-451``): no replay time, no
                    # re-materialised cache; a single-leaf segment keeps
                    # its saved input live until its own backward.
                    replay = sum(
                        sl.cost_info.compute.fwd * self.perturb
                        + sl.cost_info.net_exposed.fwd
                        for sl in seg_leaves
                        if not sl.variance_tail
                    )
                    name = seg.path_name().split(".", 1)[-1]
                    saved = seg_leaves[0].act_info.cache_bytes
                    t = yield ("compute", replay, f"{name}.recompute#mb{mb}",
                               "comp")
                    clock[0] = t
                    for sl in seg_leaves:
                        if sl.raw_act_info.cache_bytes and not sl.variance_tail:
                            self._alloc(t, sl.raw_act_info.cache_bytes,
                                        self._token(mb, sl, "r:"), "recompute")
                    if saved and not seg_leaves[0].variance_tail:
                        self._free(t, token=self._token(mb, seg_leaves[0]),
                                   tag="act")
                    for sl in reversed(seg_leaves):
                        dur = (
                            sl.cost_info.compute.bwd * self.perturb
                            + sl.cost_info.net_exposed.bwd_act
                            + sl.cost_info.net_exposed.bwd_w
                        )
                        lname = sl.path_name().split(".", 1)[-1]
                        flight = (sl.raw_act_info.bwd_temp_bytes
                                  + sl.raw_act_info.grad_flight_bytes)
                        self._alloc(clock[0], flight, tag="temp")
                        if dur:
                            t = yield ("compute", dur, f"{lname}.bwd#mb{mb}",
                                       "comp")
                            clock[0] = t
                        self._free(clock[0], flight, tag="temp")
                        if sl.variance_tail:
                            if sl is seg_leaves[0] and saved:
                                self._free(clock[0],
                                           token=self._token(mb, sl),
                                           tag="act")
                        elif sl.raw_act_info.cache_bytes:
                            self._free(clock[0], token=self._token(mb, sl, "r:"),
                                       tag="recompute")
                        done.add(id(sl))
                        for ev in self._grad_ready(sl):
                            t = yield ev
                            clock[0] = t
                    i -= 1
                    continue
                comp_a = leaf.cost_info.compute.bwd_act * self.perturb
                comp_w = leaf.cost_info.compute.bwd_w * self.perturb
                name = leaf.path_name().split(".", 1)[-1]
                for phase in ("bwd_act", "bwd_w"):
                    for point in ("pre", "post"):
                        for ev in self._comm_events(leaf, phase, point):
                            t = yield ev
                            clock[0] = t
                # grad-in-flight: incoming output-grad + outgoing
                # input-grad live while the bwd op runs
                flight = (leaf.raw_act_info.bwd_temp_bytes
                          + leaf.raw_act_info.grad_flight_bytes)
                self._alloc(clock[0], flight, tag="temp")
                if comp_a + comp_w:
                    t = yield ("compute", comp_a + comp_w,
                               f"{name}.bwd#mb{mb}", "comp")
                    clock[0] = t
                self._free(clock[0], flight, tag="temp")
                if leaf.act_info.cache_bytes:
                    self._free(clock[0], token=self._token(mb, leaf),
                               tag="act")
                done.add(id(leaf))
                for ev in self._grad_ready(leaf):
                    t = yield ev
                    clock[0] = t
                i -= 1

    # -- optimizer tail (reference ``OptimizerSimulator``) -----------------
    def _optimizer(self, clock: List[float]) -> Generator:
        st = self.st
        if st.overlap_grad_reduce:
            # buckets were posted asynchronously during the backward;
            # join the comm streams before touching the grads
            t = yield ("wait_comm",)
            clock[0] = t
        else:
            repeat = st.micro_batch_num if st.zero_state == 2 else 1
            for _ in range(repeat):
                for dim, buckets in self._dp["rs"].items():
                    group = self._dim_group(dim)
                    for i, dur in enumerate(buckets):
                        if group:
                            t = yield (
                                "collective", (f"grad_rs:{dim}", tuple(group)),
                                dur, f"grad_rs_{dim}_b{i}", group,
                            )
                        else:
                            t = yield ("compute", dur, f"grad_rs_{dim}_b{i}",
                                       "comm")
                        clock[0] = t
        if self._dp["tied"]:
            t = yield ("compute", self._dp["tied"], "tied_embedding_grad",
                       "comm")
            clock[0] = t
        # world barrier before the step (rerun_state_machine analog)
        if self._barrier_group is not None:
            barrier = list(self._barrier_group)
        else:
            barrier = list(range(self.pp if self.rank is None
                                  else st.world_size))
        t = yield (
            "collective",
            "optimizer_barrier",
            0.0,
            "optimizer_barrier",
            barrier,
        )
        clock[0] = t
        t = yield ("compute",
                   self.perf._compute_optim_time(self.stage) * self.perturb,
                   "adam_step", "comp")
        clock[0] = t
        # param all-gather: when overlapped it belongs to the NEXT
        # iteration's first forward — in this steady-state model it was
        # posted at schedule start and joined after the first
        # microbatch's forward, so nothing is charged here
        if not st.overlap_param_gather:
            for dim, buckets in self._dp["ag"].items():
                group = self._dim_group(dim)
                for i, dur in enumerate(buckets):
                    if group:
                        t = yield (
                            "collective", (f"param_ag:{dim}", tuple(group)),
                            dur, f"param_ag_{dim}_b{i}", group,
                        )
                    else:
                        t = yield ("compute", dur, f"param_ag_{dim}_b{i}",
                                   "comm")
                    clock[0] = t

    def _post_param_gathers(self) -> Generator:
        """Steady state with ``overlap_param_gather``: the previous
        iteration's param all-gathers overlap this iteration's warmup
        forward — post them on the comm streams at schedule start."""
        for dim, buckets in self._dp["ag"].items():
            for i, dur in enumerate(buckets):
                yield self._async_bucket(dim, i, dur, "param_ag")

    # -- full schedule ------------------------------------------------------
    def process(self) -> Generator:
        if self.st.vp_size > 1:
            yield from self._process_interleaved()
            return
        st, stage, pp = self.st, self.stage, self.pp
        mbc = st.micro_batch_num
        clock = [0.0]
        ag_join_pending = False
        if st.overlap_param_gather and self._dp["ag"]:
            yield from self._post_param_gathers()
            ag_join_pending = True
        b_seen = 0
        f_seen = 0
        # blocking-pipeline send semantics: warmup forward sends and
        # cooldown backward sends have a peer in a recv-only phase, so a
        # true rendezvous (send_sync) is cycle-free there; steady-state
        # sends use the async-send + sender transfer-stall
        # approximation, which is timing-identical to Megatron's real
        # batched isend/irecv pairs on a symmetric schedule — pinned by
        # the ``_steady_sendrecv`` variant below + the parity
        # regression test (docs/simulation.md "Blocking-send model";
        # unfused blocking sends would deadlock the warmup ring, which
        # is exactly why Megatron fuses them).
        warmup = pp - 1 - stage
        order = list(one_f_one_b_order(pp, stage, mbc))

        def recv_spec(op):
            """(peer, tag, name, lane) of one schedule op's inbound
            p2p, or None (boundary stages)."""
            kind, mb = op
            if kind == "F":
                if stage == 0:
                    return None
                return (self._neighbor(stage - 1), f"fwd{mb}",
                        f"recv_fwd{mb}", "pp_fwd")
            if stage == pp - 1:
                return None
            return (self._neighbor(stage + 1), f"bwd{mb}",
                    f"recv_bwd{mb}", "pp_bwd")

        def steady_send(dst, tag, name, lane, i):
            """Steady-state blocking send: batched with the next op's
            recv when ``_steady_sendrecv`` (true Megatron pairing),
            else async publish + sender transfer stall."""
            if self._steady_sendrecv:
                nxt = recv_spec(order[i + 1]) if i + 1 < len(order) else None
                if nxt is not None:
                    t = yield ("sendrecv", dst, tag, self.p2p_time,
                               nxt[0], nxt[1], f"{name}+{nxt[2]}", lane)
                    clock[0] = t
                    return True
                t = yield ("sendrecv", dst, tag, self.p2p_time,
                           None, None, name, lane)
                clock[0] = t
                return False
            t = yield ("send", dst, tag, self.p2p_time, name, lane)
            clock[0] = t
            yield ("advance", clock[0] + self.p2p_time)
            return False

        recv_batched = False  # next op's input already received by a pair
        for i, (kind, mb) in enumerate(order):
            if kind == "F":
                f_seen += 1
                if stage > 0 and not recv_batched:
                    t = yield ("recv", self._neighbor(stage - 1), f"fwd{mb}",
                               f"recv_fwd{mb}", "pp_fwd")
                    clock[0] = t
                recv_batched = False
                yield from self._fwd(mb, clock)
                if ag_join_pending:
                    # params must be resident once the first microbatch's
                    # forward has consumed them: join the gather streams
                    t = yield ("wait_comm",)
                    clock[0] = t
                    ag_join_pending = False
                if stage < pp - 1:
                    if st.pp_comm_async:
                        t = yield ("send", self._neighbor(stage + 1),
                                   f"fwd{mb}", self.p2p_time,
                                   f"send_fwd{mb}", "pp_fwd")
                        clock[0] = t
                    elif f_seen <= warmup:
                        t = yield ("send_sync", self._neighbor(stage + 1),
                                   f"fwd{mb}", self.p2p_time,
                                   f"send_fwd{mb}", "pp_fwd")
                        clock[0] = t
                    else:
                        recv_batched = yield from steady_send(
                            self._neighbor(stage + 1), f"fwd{mb}",
                            f"send_fwd{mb}", "pp_fwd", i,
                        )
            else:
                b_seen += 1
                if st.overlap_grad_reduce and (
                    st.zero_state == 2 or b_seen == mbc
                ):
                    self._begin_rs_window()
                if stage < pp - 1 and not recv_batched:
                    t = yield ("recv", self._neighbor(stage + 1), f"bwd{mb}",
                               f"recv_bwd{mb}", "pp_bwd")
                    clock[0] = t
                recv_batched = False
                yield from self._bwd(mb, clock)
                yield from self._flush_rs_window()
                if stage > 0:
                    if st.pp_comm_async:
                        t = yield ("send", self._neighbor(stage - 1),
                                   f"bwd{mb}", self.p2p_time,
                                   f"send_bwd{mb}", "pp_bwd")
                        clock[0] = t
                    elif b_seen > mbc - warmup:
                        t = yield ("send_sync", self._neighbor(stage - 1),
                                   f"bwd{mb}", self.p2p_time,
                                   f"send_bwd{mb}", "pp_bwd")
                        clock[0] = t
                    else:
                        recv_batched = yield from steady_send(
                            self._neighbor(stage - 1), f"bwd{mb}",
                            f"send_bwd{mb}", "pp_bwd", i,
                        )
        yield from self._optimizer(clock)

    def _process_interleaved(self) -> Generator:
        """Interleaved (VPP) schedule: chunk c's forward on the last
        stage feeds chunk c+1 on stage 0; backward wraps the other way
        (Megatron interleaved 1F1B, reference
        ``pipeline_schedule.py:97-715``)."""
        from simumax_tpu_torch.parallel.pipeline import interleaved_order

        st, stage, pp = self.st, self.stage, self.pp
        vp, mbc = st.vp_size, st.micro_batch_num
        group = st.vpp_group_size
        by_chunk = {c.chunk_idx: [c] for c in self.chunks}
        clock = [0.0]
        order = interleaved_order(pp, stage, mbc, vp, group)
        n_b = sum(1 for op in order if op[0] == "B")
        ag_join_pending = False
        if st.overlap_param_gather and self._dp["ag"]:
            yield from self._post_param_gathers()
            ag_join_pending = True
        b_seen = 0
        rs_begun: set = set()

        def specs(op):
            """(recv, send) p2p specs of one schedule op; each is
            ``(peer, tag, name, lane)`` or None."""
            kind, c, mb = op
            if kind == "F":
                recv = None
                if not (stage == 0 and c == 0):
                    src = self._neighbor(stage - 1 if stage > 0 else pp - 1)
                    recv = (src, f"fwd_c{c}_mb{mb}",
                            f"recv_fwd_c{c}_mb{mb}", "pp_fwd")
                send = None
                if not (stage == pp - 1 and c == vp - 1):
                    dst = self._neighbor(stage + 1 if stage < pp - 1 else 0)
                    rc = c if stage < pp - 1 else c + 1
                    send = (dst, f"fwd_c{rc}_mb{mb}",
                            f"send_fwd_c{rc}_mb{mb}", "pp_fwd")
                return recv, send
            recv = None
            if not (stage == pp - 1 and c == vp - 1):
                src = self._neighbor(stage + 1 if stage < pp - 1 else 0)
                recv = (src, f"bwd_c{c}_mb{mb}",
                        f"recv_bwd_c{c}_mb{mb}", "pp_bwd")
            send = None
            if not (stage == 0 and c == 0):
                dst = self._neighbor(stage - 1 if stage > 0 else pp - 1)
                rc = c if stage > 0 else c - 1
                send = (dst, f"bwd_c{rc}_mb{mb}",
                        f"send_bwd_c{rc}_mb{mb}", "pp_bwd")
            return recv, send

        recv_batched = False  # next op's input already received by a pair
        for i, op in enumerate(order):
            kind, c, mb = op
            recv, send = specs(op)
            if kind == "B":
                b_seen += 1
                # grad-reduce windows (interleaved): ZeRO-2 reduces each
                # microbatch's grads — its window spans that mb's chunk
                # backwards (chunk vp-1 first, chunk 0 last); otherwise
                # grads are final only on the last microbatch, whose
                # window spans its B ops until the schedule's final B
                if st.overlap_grad_reduce:
                    if st.zero_state == 2:
                        if mb not in rs_begun:
                            yield from self._flush_rs_window()
                            rs_begun.add(mb)
                            self._begin_rs_window()
                    elif mb == mbc - 1 and not self._rs_active:
                        self._begin_rs_window()
            if recv is not None and not recv_batched:
                t = yield ("recv", recv[0], recv[1], recv[2], recv[3])
                clock[0] = t
            recv_batched = False
            if kind == "F":
                yield from self._fwd(mb, clock, by_chunk[c])
                if ag_join_pending:
                    t = yield ("wait_comm",)
                    clock[0] = t
                    ag_join_pending = False
            else:
                yield from self._bwd(mb, clock, by_chunk[c])
                if st.overlap_grad_reduce and (
                    (st.zero_state == 2 and c == 0) or b_seen == n_b
                ):
                    yield from self._flush_rs_window()
            if send is not None:
                if st.pp_comm_async:
                    t = yield ("send", send[0], send[1], self.p2p_time,
                               send[2], send[3])
                    clock[0] = t
                else:
                    # Megatron blocking interleaved: the send is batched
                    # with the NEXT op's recv in one batch_isend_irecv
                    # call (reference pipeline_schedule.py:344-592) —
                    # publish-then-pair semantics, so warmup rings of
                    # mutual sends cannot deadlock (engine "sendrecv")
                    nxt = specs(order[i + 1])[0] if i + 1 < len(order) else None
                    if nxt is not None:
                        t = yield ("sendrecv", send[0], send[1],
                                   self.p2p_time, nxt[0], nxt[1],
                                   f"{send[2]}+{nxt[2]}", send[3])
                        clock[0] = t
                        recv_batched = True
                    else:
                        t = yield ("sendrecv", send[0], send[1],
                                   self.p2p_time, None, None, send[2],
                                   send[3])
                        clock[0] = t
        yield from self._optimizer(clock)
