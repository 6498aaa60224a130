"""The port's analytical copy (``simumax_tpu_torch.perf`` and the modules
it reaches) against the JAX package's ``PerfLLM``, its H100 system
config, and the calibration and bench entry points on a box without a
card.

The analytical model is plain Python copied with its import paths
changed, so the two packages must agree to rel 1e-12 on a TPU system
config, with the attention backend mapped xla -> torch and pallas ->
cuda.
"""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from simumax_tpu import PerfLLM as JaxPerfLLM  # noqa: E402
from simumax_tpu.core.config import StrategyConfig as JaxStrategy  # noqa: E402
from simumax_tpu_torch import PerfLLM, StrategyConfig  # noqa: E402
from simumax_tpu_torch import bench  # noqa: E402
from simumax_tpu_torch.calibration import autocal  # noqa: E402
from simumax_tpu_torch.core.config import get_system_config, list_configs  # noqa: E402
from simumax_tpu_torch.core.errors import ConfigError  # noqa: E402

BACKENDS = {"xla": "torch", "pallas": "cuda"}


def _bench_strategy(cls, backend, flash, seq=2048):
    st = cls(world_size=1, tp_size=1, pp_size=1, seq_len=seq, micro_batch_size=1,
             micro_batch_num=1, zero_state=0, use_flash_sdp=flash, use_math_sdp=not flash,
             sdp_backend=backend, use_fp32_accum_grad=False,
             optimizer_style="functional")
    st.__post_init__()
    return st


CASES = [
    ("tp1_pp2_dp4_mbs1", "llama3-8b", None),
    ("tp8_pp1_dp1_mbs1", "llama3-70b", None),
    ("bench", "bench-llama-0p5b", "xla"),
    ("bench", "bench-llama-0p5b", "pallas"),
    ("tp1_pp1_dp8_mbs1", "mixtral-8x1b", None),
    ("ep4_pp2_dp4_mbs1", "mixtral-8x7b", None),
    ("ep4_pp2_dp4_mbs1_full_recompute", "mixtral-8x7b", None),
    ("ep8_pp1_dp8_mbs1", "deepseekv2-lite", None),  # MLA + MoE
]


@pytest.mark.parametrize("strategy,model,backend", CASES,
                         ids=["llama3-8b", "llama3-70b", "bench-math", "bench-flash",
                              "mixtral-8x1b", "mixtral-8x7b-ep4", "mixtral-8x7b-ep4-recompute",
                              "deepseekv2-lite-mla"])
def test_analytical_copy_matches_jax_package(strategy, model, backend):
    if strategy == "bench":
        flash = backend == "pallas"
        jst = _bench_strategy(JaxStrategy, backend, flash)
        tst = _bench_strategy(StrategyConfig, BACKENDS[backend], flash)
    else:
        jst = tst = strategy
    ref = JaxPerfLLM().configure(jst, model, "tpu_v5e_256")
    ref.run_estimate()
    got = PerfLLM().configure(tst, model, "tpu_v5e_256")
    got.run_estimate()
    for key in ("iter_time", "mfu"):
        assert got.analysis_cost()[key] == pytest.approx(ref.analysis_cost()[key], rel=1e-12)
    assert got.analysis_mem()["max_peak_gib"] == pytest.approx(
        ref.analysis_mem()["max_peak_gib"], rel=1e-12)
    # the same efficiency-table misses, keyed by the mapped backend
    mapped = {
        op: sorted(k.replace("backend=pallas", "backend=cuda") for k in keys)
        for op, keys in ref.system.miss_efficiency.items()
    }
    assert mapped == {op: sorted(keys) for op, keys in got.system.miss_efficiency.items()}


@pytest.mark.parametrize("flash", [False, True])
def test_bench_row_misses_the_reference_key_set_on_h100(flash):
    mc = bench.build_bench_model()
    perf = bench.predict_step(mc, "h100_sxm", kind="flash" if flash else "dense")
    misses = {op: len(keys) for op, keys in perf.system.miss_efficiency.items()}
    assert misses == {"matmul": 15, "sdp_fwd": 1, "sdp_bwd": 1}
    assert "fused_adam" not in perf.system.accelerator.bandwidth  # calibrated too
    sdp_key = next(iter(perf.system.miss_efficiency["sdp_fwd"]))
    assert sdp_key.startswith("backend=cuda, ") is flash
    cost = perf.analysis_cost()
    assert 0 < cost["iter_time"] < 1 and 0 < cost["mfu"] < 1


def test_h100_config_is_the_packages_own_and_single_card():
    assert "h100_sxm" in list_configs()["system"]
    sysc = get_system_config("h100_sxm")
    assert sysc.config_path.endswith("simumax_tpu_torch/configs/system/h100_sxm.json")
    acc = sysc.accelerator
    assert acc.backend == "cuda" and acc.mem_gbs == 80
    assert {k: v.tflops for k, v in acc.op.items()} == {
        "default": 989, "matmul": 989, "group_matmul": 989, "sdp_fwd": 989,
        "sdp_bwd": 989, "int8_matmul": 1979, "int8_group_matmul": 1979}
    assert {v.gbps for v in acc.bandwidth.values()} == {3350}
    assert sysc.ici is None and sysc.dcn is None and sysc.total_chips == 1
    assert sysc.fingerprint()
    assert sysc.place_group("tp", 1, 1).spans == []
    with pytest.raises(ConfigError, match="later slice"):
        sysc.place_group("dp", 1, 2)
    with pytest.raises(ConfigError, match="exceeds"):
        PerfLLM().configure("tp2_pp1_dp4_mbs1", "llama3-8b", "h100_sxm")


def test_strategy_backends_and_shape_gate():
    with pytest.raises(ConfigError, match="unknown sdp_backend"):
        _bench_strategy(StrategyConfig, "xla", False).sanity_check()
    with pytest.raises(ConfigError, match="use_flash_sdp"):
        _bench_strategy(StrategyConfig, "cuda", False).sanity_check()
    mc = bench.build_bench_model()
    with pytest.raises(ConfigError, match="CUDA flash kernels"):
        PerfLLM().configure(_bench_strategy(StrategyConfig, "cuda", True, seq=2000),
                            mc, "h100_sxm")


#: the efficiency-table keys each row's estimate misses on h100_sxm (the
#: JAX package's ``accuracy_table.predict`` misses as many on tpu_v5e_256)
ROW_MISSES = {
    "llama-0.5B int8": {"int8_matmul": 12, "matmul": 3, "sdp_fwd": 1, "sdp_bwd": 1},
    "moe-8e-top2 bf16": {"group_matmul": 6, "matmul": 9, "sdp_fwd": 1, "sdp_bwd": 1},
}


@pytest.mark.parametrize("label", list(ROW_MISSES))
def test_int8_and_moe_rows_miss_their_own_keys_on_h100(label):
    """The int8 row misses the int8 GEMMs of its linear layers (the LM
    head stays a bf16 ``matmul``, three keys), the MoE row its expert
    GEMMs as ``group_matmul`` keys: these are what calibrate measures."""
    _label, kind, seq, mbs, layers, remat = next(r for r in bench.ROWS if r[0] == label)
    perf = bench.predict_step(bench.build_model(kind), "h100_sxm", kind, seq, mbs, layers, remat)
    misses = perf.system.miss_efficiency
    assert {op: len(keys) for op, keys in misses.items()} == ROW_MISSES[label]
    if kind == "int8":
        assert {autocal._parse_key(k)["layout"] for k in misses["int8_matmul"]} == {
            "NN", "NT", "TN"}
    else:
        assert {autocal._parse_key(k)["ng"] for k in misses["group_matmul"]} == {"8"}
    cost = perf.analysis_cost()
    assert 0 < cost["iter_time"] < 1 and 0 < cost["mfu"] < 1


@pytest.mark.parametrize("row", bench.ROWS, ids=[r[0] for r in bench.ROWS])
def test_bench_rows_predict_what_the_accuracy_table_predicts(row):
    """Each row of the loop, set as ``tools/accuracy_table.py``'s
    ``predict`` sets it (int8 -> fp8 + quant_dtype int8, remat ->
    full-block recompute, capacity factor 2), predicts the same step on
    a TPU system config, with the backend mapped."""
    from tools import accuracy_table

    label, kind, seq, mbs, layers, remat = row
    ref_mc = accuracy_table.moe_model() if kind == "moe" else accuracy_table.dense_model()
    ref = accuracy_table.predict(ref_mc, seq, mbs, layers, remat, "tpu_v5e_256", kind)
    got = bench.predict_step(bench.build_model(kind), "tpu_v5e_256", kind, seq, mbs, layers,
                             remat)
    for key in ("iter_time", "mfu"):
        assert got.analysis_cost()[key] == pytest.approx(ref.analysis_cost()[key], rel=1e-12)
    assert got.analysis_mem()["max_peak_gib"] == pytest.approx(
        ref.analysis_mem()["max_peak_gib"], rel=1e-12)
    assert got.strategy.sdp_backend == BACKENDS[ref.strategy.sdp_backend]
    mapped = {op: sorted(k.replace("backend=pallas", "backend=cuda") for k in keys)
              for op, keys in ref.system.miss_efficiency.items()}
    assert mapped == {op: sorted(keys) for op, keys in got.system.miss_efficiency.items()}


@pytest.mark.parametrize("method,args", [
    ("critical_path", ()), ("predict_goodput", (None,)), ("analyze_faults", ()),
    ("rebatched_iter_time", (2,)), ("analysis_dualpp", ()),
])
def test_unported_methods_name_their_roadmap_item(method, args):
    """The five methods that raised NotImplementedError naming ROADMAP
    queue A item 4 until the fault model, the critical-path engine,
    DualPipe and the search's pruning were ported: each now runs and
    returns the JAX package's value, equal as JSON (the fault methods
    on the scalar engine, which the JAX package runs here too)."""
    import json

    from simumax_tpu.simulator import faults as jf
    from simumax_tpu_torch.simulator import faults as tf

    got, ref = (cls().configure("tp1_pp2_dp4_mbs1", "llama3-8b", "tpu_v5e_256")
                for cls in (PerfLLM, JaxPerfLLM))
    for perf in (got, ref):
        perf.run_estimate()
    values = []
    for perf, fm in ((got, tf), (ref, jf)):
        kw = {}
        if method in ("predict_goodput", "analyze_faults"):
            kw = dict(_ctx=fm.ReplayContext(perf, options=fm.ReplayOptions(
                replay_backend="numpy")))
        if method == "predict_goodput":
            args = (fm.FaultScenario([fm.FaultEvent("preemption", 5.0, duration_ms=20.0,
                                                    rank=3)], horizon_steps=4),)
        if method == "analyze_faults":
            kw.update(n_scenarios=3, horizon_steps=4)
        out = getattr(perf, method)(*args, **kw)
        values.append(json.dumps(out.to_dict() if hasattr(out, "to_dict") else out,
                                 sort_keys=True, default=str))
    assert values[0] == values[1]


def test_calibration_helpers(monkeypatch):
    key = ("backend=cuda, b=1, sq=2048, skv=2048, hn=16, kv_hn=8, hd=128, hd_v=128, "
           "causal=True, flash=True, dtype=bf16")
    kv = autocal._parse_key(key)
    assert kv["backend"] == "cuda" and kv["sq"] == "2048" and kv["causal"] == "True"
    assert autocal.validate_efficiency(0.5) == 0.5
    with pytest.raises(autocal.CalibrationError):
        autocal.validate_efficiency(1.5, "matmul", "x")
    # int8 keys are measured on the card like the others (b > 1: skipped)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h100 = get_system_config("h100_sxm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autocal.calibrate_key("int8_matmul", "b=1, m=2048, k=2048, n=4096, layout=NT", h100)
    assert autocal.calibrate_key("int8_matmul", "b=2, m=64, k=64, n=64, layout=NN",
                                 h100) is None


def test_with_retries_retries_only_a_device_oom():
    calls = []

    def oom():
        calls.append("oom")
        raise torch.cuda.OutOfMemoryError("memory held by a neighbour")

    def launch_failure():
        calls.append("launch")
        raise RuntimeError("flash_fwd: CUDA kernel launch failed with cudaError 1")

    with pytest.raises(autocal.CalibrationError, match="out of device memory 2 times"):
        autocal.with_retries(oom, attempts=2, backoff=0.0)
    with pytest.raises(RuntimeError, match="launch failed"):
        autocal.with_retries(launch_failure, attempts=2, backoff=0.0)
    assert calls == ["oom", "oom", "launch"]


def test_entry_points_without_device_raise_off_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc = bench.build_bench_model()
    perf = bench.predict_step(mc, "h100_sxm")
    for call in (
        lambda: bench.detect_system(),
        lambda: bench.measure_step(mc, seq_len=64),
        lambda: bench.main(),
        lambda: autocal.calibrate_for_perf(perf),
        lambda: autocal.measure_gemm_efficiency(64, 64, 64, "bf16", "bf16", 989.0),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asking for the CPU does not make a measurement: there is no card to time
    with pytest.raises(RuntimeError, match="CUDA card"):
        autocal.calibrate_for_perf(perf, device="cpu")
    assert not perf.system.accelerator.op["matmul"].accurate_efficient_factor
