"""Interactive web app — structured config editors, estimate + memory +
simulator + search tabs, artifact download.

Port of the JAX package's ``app/streamlit_app.py``, its imports taken
from ``simumax_tpu_torch``. Requires ``streamlit`` (not part of the
baked environment): ``pip install streamlit`` then ``streamlit run
simumax_tpu_torch/app/streamlit_app.py``. The same workflows are
available without extra deps through ``python -m simumax_tpu_torch``;
the full render path is exercised headlessly by
``tests/test_torch_app.py``.

Every evaluation routes through the port's :class:`Planner` facade
(``simumax_tpu_torch/service/planner.py``): streamlit re-runs this whole
script on *every* widget interaction, and the planner's persistent
content-addressed cache turns those re-runs into ~ms cache hits instead
of full model rebuilds. Results are bit-identical to direct evaluation.

Differences from the JAX app: the body is :func:`main`, which runs when
the script runs as ``__main__`` (as ``streamlit run`` executes it), so
the module imports without streamlit and the port's module walk can
import it; a sidebar ``device`` select (``cuda`` first, as the command
line's ``--device``) says where the planner runs its fault replay and
search folds; the efficiency-miss hint names the port's ``calibrate``,
and the artifact zip is ``simumax_tpu_torch_results.zip``.
"""

import io
import json
import os
import sys
import zipfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from simumax_tpu_torch.core.config import (  # noqa: E402
    ConfigError,
    ModelConfig,
    StrategyConfig,
    get_model_config,
    get_strategy_config,
    get_system_config,
    list_configs,
)
from simumax_tpu_torch.core.errors import FeasibilityError  # noqa: E402
from simumax_tpu_torch.service.planner import Planner  # noqa: E402


def main():
    import streamlit as st

    # one planner per process; streamlit's per-interaction script re-runs
    # all hit the same persistent store, so only the first evaluation of a
    # configuration pays for a model build
    _planner = st.cache_resource(Planner) if hasattr(st, "cache_resource") \
        else Planner
    st.set_page_config(page_title="simumax-tpu-torch", layout="wide")
    st.title("simumax-tpu — analytical LLM training simulator (PyTorch/CUDA port)")
    # where the planner's fault replay and search folds run: the card unless
    # the CPU is picked, as the command line's --device
    device = st.sidebar.selectbox("device", ["cuda", "cpu"])
    planner = _planner(device=device)

    cfgs = list_configs()

    # -- sidebar: structured editors ------------------------------------------

    def _num(label, value, min_value=1, step=1):
        return int(st.sidebar.number_input(
            label, value=int(value), min_value=min_value, step=step
        ))

    with st.sidebar:
        st.subheader("configs")
        model_name = st.selectbox("model", cfgs["models"], index=max(
            cfgs["models"].index("llama3-8b") if "llama3-8b" in cfgs["models"] else 0, 0))
        strategy_name = st.selectbox("strategy", cfgs["strategy"])
        system_name = st.selectbox("system", cfgs["system"])

    model = get_model_config(model_name)
    strategy = get_strategy_config(strategy_name)
    system = get_system_config(system_name)

    def _fnum(label, value, min_value=0.001):
        # plain st.number_input so the widget lands INSIDE the active
        # `with <container>` block (st.sidebar.* always targets sidebar root)
        return float(st.number_input(
            label, value=float(value), min_value=float(min_value)
        ))

    # -- hardware editor (reference app's 硬件参数配置 section) ---------------
    with st.sidebar.expander("hardware overrides"):
        base_tflops = system.accelerator.op["default"].tflops
        new_tflops = _fnum("bf16 TFLOPs/chip", base_tflops)
        new_mem = _fnum("HBM GiB/chip", system.accelerator.mem_gbs)
        base_hbm = system.accelerator.bandwidth["default"].gbps
        new_hbm = _fnum("HBM GB/s", base_hbm)
        new_ici = _fnum("ICI link GB/s", system.ici.link_gbps)
        if new_tflops != base_tflops:
            scale = new_tflops / base_tflops
            for op in system.accelerator.op.values():
                op.tflops *= scale  # int8 classes keep their 2x ratio
        system.accelerator.mem_gbs = new_mem
        if new_hbm != base_hbm:
            scale = new_hbm / base_hbm
            for bw in system.accelerator.bandwidth.values():
                bw.gbps *= scale
        system.ici.link_gbps = new_ici

    st.sidebar.subheader("parallelism")
    strategy.world_size = _num("world_size", strategy.world_size)
    strategy.tp_size = _num("tp", strategy.tp_size)
    strategy.cp_size = _num("cp", strategy.cp_size)
    strategy.ep_size = _num("ep", strategy.ep_size)
    strategy.pp_size = _num("pp", strategy.pp_size)
    strategy.interleaving_size = _num("vpp chunks", strategy.interleaving_size)
    strategy.zero_state = _num("ZeRO state", strategy.zero_state, min_value=0)

    st.sidebar.subheader("batch / sequence")
    strategy.seq_len = _num("seq_len", strategy.seq_len, step=1024)
    strategy.micro_batch_size = _num("micro_batch_size", strategy.micro_batch_size)
    strategy.micro_batch_num = _num("micro_batch_num", strategy.micro_batch_num)
    _dtypes = ["bf16", "fp32"]
    strategy.dtype = st.sidebar.selectbox(
        "dtype", _dtypes,
        index=_dtypes.index(strategy.dtype) if strategy.dtype in _dtypes else 0,
    )
    with st.sidebar.expander("advanced pipeline options"):
        # uneven PP (reference app's PP层数高级选项): 0 = even split.
        # plain st.number_input so the widgets land inside the expander.
        strategy.num_layers_in_first_pipeline_stage = int(st.number_input(
            "layers in first stage (0 = even)",
            value=int(strategy.num_layers_in_first_pipeline_stage), min_value=0,
        ))
        strategy.num_layers_in_last_pipeline_stage = int(st.number_input(
            "layers in last stage (0 = even)",
            value=int(strategy.num_layers_in_last_pipeline_stage), min_value=0,
        ))

    st.sidebar.subheader("recompute")
    _grans = ["none", "full_block", "selective", "attn_only", "mlp_only"]
    _cur_gran = (
        strategy.recompute_granularity if strategy.enable_recompute else "none"
    )
    gran = st.sidebar.selectbox(
        "granularity", _grans,
        index=_grans.index(_cur_gran) if _cur_gran in _grans else 0,
    )
    strategy.enable_recompute = gran != "none"
    if strategy.enable_recompute:
        strategy.recompute_granularity = gran
        strategy.recompute_layer_num = _num(
            "recompute layers (-1 = all)", strategy.recompute_layer_num,
            min_value=-1,
        )

    st.sidebar.subheader("model overrides")
    model.layer_num = _num("layers", model.layer_num)
    model.hidden_size = _num("hidden_size", model.hidden_size, step=128)
    model.intermediate_size = _num("ffn size", model.intermediate_size, step=128)
    model.head_num = _num("heads", model.head_num)
    model.kv_head_num = _num("kv heads", model.kv_head_num)
    if model.model_type == "moe":
        model.expert_num = _num("experts", model.expert_num)
        model.topk = _num("topk", model.topk)

    with st.expander("edit raw model json (advanced)"):
        # streamlit retains edited widget text across reruns, which would
        # silently discard later sidebar edits if the raw JSON always won;
        # apply it only while the checkbox is on
        model_json = st.text_area(
            "model json", json.dumps(model.to_dict(), indent=2), height=240
        )
        if st.checkbox("apply raw model json (overrides sidebar)"):
            model = ModelConfig.init_from_dict(json.loads(model_json))
    with st.expander("edit raw strategy json (advanced)"):
        strategy_json = st.text_area(
            "strategy json", json.dumps(strategy.to_dict(), indent=2, default=str),
            height=240,
        )
        if st.checkbox("apply raw strategy json (overrides sidebar)"):
            data = json.loads(strategy_json)
            data.pop("recompute", None)
            strategy = StrategyConfig.init_from_dict(data)

    strategy.__post_init__()  # re-derive dp_size/recompute from the edits

    run_sim = st.checkbox("also run the event simulator (Chrome trace)")

    tab_est, tab_mem, tab_sim, tab_search = st.tabs(
        ["estimate", "memory", "simulator", "search"]
    )

    if st.button("estimate"):
        try:
            # planner facade: persistent content-addressed cache shared
            # with the CLI and the serve server; bit-identical to a direct
            # PerfLLM evaluation
            result = planner.estimate(model, strategy, system)
        except ConfigError as e:
            st.error(f"infeasible config: {e}")
            st.stop()
        cost, mem = result["compute_result"], result["mem_result"]

        with tab_est:
            c1, c2, c3, c4 = st.columns(4)
            c1.metric("iteration", f"{cost['iter_time_ms']:.1f} ms")
            c2.metric("MFU", f"{cost['mfu']*100:.2f} %")
            c3.metric("TFLOPS/chip", f"{cost['tflops_per_chip']:.1f}")
            c4.metric(
                "peak HBM",
                f"{mem['max_peak_gib']:.2f} GiB",
                delta="fits" if mem["fits"] else "DOES NOT FIT",
                delta_color="normal" if mem["fits"] else "inverse",
            )
            st.subheader("time breakdown")
            tb = cost.get("time_breakdown", {})
            # *_per_microbatch entries are one microbatch; scale them so
            # every row is per-iteration and the rows sum meaningfully
            mbc = max(strategy.micro_batch_num, 1)
            st.dataframe([
                {
                    "phase": k.replace("_per_microbatch", ""),
                    "ms": round(
                        v * 1e3 * (mbc if k.endswith("_per_microbatch") else 1),
                        3,
                    ),
                }
                for k, v in tb.items()
            ])
            st.subheader("mesh placement")
            st.json(result["net_info"])
            misses = result["efficiency_misses"]
            if misses:
                st.info(
                    f"{sum(len(v) for v in misses.values())} efficiency-table "
                    "misses — run `python -m simumax_tpu_torch calibrate` on "
                    "the card to refine the prediction."
                )
            # warnings / suggestions (reference app's 警告信息 + 提示/建议)
            st.subheader("warnings / suggestions")
            warnings = []
            if not mem["fits"]:
                warnings.append(
                    f"peak {mem['max_peak_gib']:.1f} GiB exceeds usable HBM — "
                    "enable recompute, raise zero_state (FSDP=3), increase "
                    "tp/pp, or use more chips"
                )
            # pp across DCN is the recommended multi-slice layout (tiny p2p
            # volume) — only warn when a bandwidth-heavy dim spills; dp_cp
            # is the same physical group as dp, so don't list it twice.
            # net_info carries the CommPath descriptions ("dcn[...]" marks
            # a span beyond the slice)
            dcn_dims = [
                d for d, desc in result["net_info"].items()
                if "dcn[" in desc and d not in ("pp", "dp_cp")
            ]
            if dcn_dims:
                hint = (
                    "enable overlap_grad_reduce/overlap_param_gather to hide "
                    "the DP gradient traffic, or try mesh_order='tp,cp,dp,pp' "
                    "to put pipeline p2p across slices instead"
                    if "dp" in dcn_dims
                    else "prefer layouts that keep tp/cp/ep inside the slice"
                )
                warnings.append(
                    f"parallel dims {', '.join(dcn_dims)} spill onto DCN "
                    f"(~10-100x less bandwidth than ICI) — {hint}"
                )
            bubble = cost.get("bubble_time", 0.0) / max(cost["iter_time"], 1e-9)
            if bubble > 0.2:
                warnings.append(
                    f"pipeline bubble is {bubble * 100:.0f}% of the "
                    "iteration — raise micro_batch_num or use interleaving "
                    "(vpp)"
                )
            if warnings:
                for w in warnings:
                    st.write(f"- {w}")
            else:
                st.write("none — configuration looks healthy")
            with st.expander("realized collective bandwidths (GB/s)"):
                st.json(result["real_comm_bw"])
            dual = result.get("dualpp")
            if dual:
                st.subheader("DualPipe projection")
                st.write(
                    f"bidirectional schedule: "
                    f"{dual['dualpp_iter_time'] * 1e3:.1f} ms "
                    f"({dual['speedup']:.2f}x vs 1F1B) at "
                    f"{dual['max_peak_gib']:.1f} GiB peak "
                    f"(2 stage chunks per rank vs "
                    f"{dual['baseline_peak_gib']:.1f} GiB)"
                )

        with tab_mem:
            st.subheader("per-stage memory")
            st.dataframe(mem["stages"])
            # per-stage breakdown (reference app's 模型内存细分 expander)
            # model_bytes = weight + grad + optimizer_state (an aggregate)
            # and peak/replay_peak are metrics, not components — exclude so
            # the component rows sum to real memory
            _components = (
                "weight_bytes", "grad_bytes", "optimizer_state_bytes",
                "act_cache_per_microbatch_bytes",
            )
            for s in mem["stages"]:
                with st.expander(f"stage {s['stage']} breakdown"):
                    st.dataframe([
                        {"component": k.replace("_bytes", ""),
                         "GiB": round(s[k] / 2**30, 3)}
                        for k in _components if k in s
                    ])

        artifacts = {
            "base_info.json": result["base_info"],
            "mem_result.json": mem,
            "compute_result.json": cost,
            "net_info.json": result["net_info"],
        }
        if run_sim:
            # artifact-producing simulate rides the facade too (uncached —
            # the trace/snapshot files live outside the store)
            sim = planner.simulate(model, strategy, system,
                                   save_path="tmp/app_sim")
            with tab_sim:
                st.subheader("event simulator")
                st.write(
                    f"event-simulated iteration: {sim['end_time_ms']:.2f} ms "
                    f"({sim['num_events']} events)"
                )
                for m in sim["memory"]:
                    st.write(
                        f"stage {m['rank']}: simulated peak "
                        f"{m['peak_gib']:.2f} GiB at {m['peak_time_ms']:.1f} ms"
                    )
                    cats = m.get("peak_by_category") or {}
                    if cats:
                        st.subheader(f"stage {m['rank']} — who holds the peak")
                        st.dataframe([
                            {"holder": k, "GiB": round(v / 2**30, 3)}
                            for k, v in cats.items()
                        ])
                # memory timeline chart from the snapshot artifact
                snap_path = os.path.join("tmp/app_sim", "simu_memory_snapshot.json")
                if os.path.exists(snap_path):
                    with open(snap_path) as f:
                        snaps = json.load(f)
                    for snap in snaps[:1]:
                        st.line_chart(
                            {"GiB": [s["bytes"] / 2**30
                                     for s in snap["timeline"]]},
                        )
            with open(sim["trace_path"]) as f:
                artifacts["trace.json"] = json.load(f)

        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            for name, data in artifacts.items():
                z.writestr(name, json.dumps(data, indent=1, default=str))
        st.download_button("download artifacts (.zip)", buf.getvalue(),
                           "simumax_tpu_torch_results.zip")

    with tab_search:
        st.subheader("batch-split search at this layout")
        gbs = int(st.number_input(
            "global batch size", value=max(
                strategy.micro_batch_size * strategy.micro_batch_num
                * max(strategy.dp_size, 1), 1,
            ), min_value=1,
        ))
        if st.button("search batch split"):
            dp = strategy.dp_size
            if dp < 1:
                st.error(
                    f"infeasible layout: world_size {strategy.world_size} < "
                    f"tp*cp*pp = "
                    f"{strategy.tp_size * strategy.cp_size * strategy.pp_size}"
                )
                st.stop()
            if gbs % dp:
                gbs = max(gbs // dp, 1) * dp
                st.info(f"global batch size rounded to {gbs} "
                        f"(must divide by dp={dp})")
            try:
                best = planner.batch_split(
                    model, strategy, system, global_batch_size=gbs
                )["row"]
            except FeasibilityError as e:
                st.error(f"infeasible split: {e}")
                st.stop()
            if best is None:
                st.error("no feasible (mbs, mbc) split at this layout")
            else:
                st.dataframe([{
                    k: best[k] for k in (
                        "mbs", "mbc", "mfu", "iter_ms", "peak_gib", "fits"
                    )
                }])


if __name__ == "__main__":
    main()
