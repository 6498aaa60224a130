"""The port's calibration (``simumax_tpu_torch/calibration/``, the tools
that build on it, and ``bench.detect_system``) against the JAX
package's, on a box without a card.

A microbenchmark's time can only be measured on the card, so the
traffic and FLOP conventions are held equal instead: with the timer
fixed at the same seconds on both sides (the JAX package's ``_time_op``
and the port's graph timer), the two compute the same efficiencies.
For these tests only, the port's card check hands out the CPU device;
the port's timer still runs each benchmark's op once on the CPU.
"""

import json
import warnings

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu.calibration import autocal as jax_autocal  # noqa: E402
from simumax_tpu.calibration import timing as jax_timing  # noqa: E402
from simumax_tpu.core.config import get_system_config as jax_system  # noqa: E402
from simumax_tpu_torch import bench  # noqa: E402
from simumax_tpu_torch.calibration import autocal, timing, validate  # noqa: E402
from simumax_tpu_torch.core.config import get_system_config  # noqa: E402
from simumax_tpu_torch.core.errors import CalibrationError  # noqa: E402
from simumax_tpu_torch.tools import build_system_config, validate_memory_table  # noqa: E402
from simumax_tpu_torch.torchref import kernels as K  # noqa: E402
from tools import validate_memory_table as jax_memory_table  # noqa: E402

#: seconds per call that both timers report; long enough that the JAX
#: Adam timer keeps its pilot scan (8 x 0.05 s >= its 0.2 s target)
SECONDS = 0.05
NBYTES = 2 ** 20
CLASSES = ["default", "permute_fwd", "permute_bwd", "ce", "fused_adam"]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture
def fixed_timers(monkeypatch):
    """Both packages' timers report ``SECONDS`` a call; the port's runs
    its op once (on the CPU, where its card check now points) first."""
    ran = []

    def port_timer(fn, *args, **kwargs):
        ran.append(fn(*args))
        return SECONDS

    monkeypatch.setattr(autocal, "_card", lambda device="cuda": torch.device("cpu"))
    monkeypatch.setattr(autocal, "time_graph", port_timer)
    monkeypatch.setattr(autocal, "card_identity", lambda device="cuda": CARD)
    monkeypatch.setattr(jax_autocal, "_time_op", lambda op, arrays, **kw: SECONDS)
    monkeypatch.setattr(jax_timing, "time_fn", lambda fn, *a, **kw: 8 * SECONDS)
    monkeypatch.setattr(jax_timing, "fetch_rtt", lambda refresh=False: 0.0)
    return ran


@pytest.mark.parametrize("kind", CLASSES)
def test_bandwidth_traffic_matches_jax(fixed_timers, kind):
    """Each class counts the JAX package's traffic: the same seconds give
    the same efficiency (far below 1, so nothing is clipped)."""
    gbps = get_system_config("h100_sxm").accelerator.bandwidth["default"].gbps
    got = autocal.measure_bandwidth_efficiency(kind, gbps, NBYTES)
    ref = jax_autocal.measure_bandwidth_efficiency(kind, gbps, NBYTES)
    assert 0 < got < 1e-3
    assert got == pytest.approx(ref, rel=1e-12)
    out = fixed_timers[-1]
    if kind == "permute_bwd":  # the gather's backward: the rows scattered back
        x = autocal._test_array((NBYTES // 2048, 1024), torch.bfloat16, "cpu")
        assert torch.equal(torch.sort(out.float(), dim=0).values,
                           torch.sort(x.float(), dim=0).values)
    if kind == "ce":  # the loss of torchref/model.py on the test logits
        assert out.dtype == torch.float32 and out.ndim == 0 and torch.isfinite(out)


def test_ce_fusion_is_refused_as_in_jax(fixed_timers):
    for measure, error in ((autocal.measure_bandwidth_efficiency, CalibrationError),
                           (jax_autocal.measure_bandwidth_efficiency,
                            jax_autocal.CalibrationError)):
        with pytest.raises(error, match="ce_fusion"):
            measure("ce_fusion", 3350.0, NBYTES)


def test_calibrate_bandwidth_classes_writes_what_jax_writes(fixed_timers):
    port, ref = get_system_config("tpu_v5e_256"), jax_system("tpu_v5e_256")
    got = autocal.calibrate_bandwidth_classes(port, nbytes=NBYTES)
    want = jax_autocal.calibrate_bandwidth_classes(ref, nbytes=NBYTES)
    assert list(got) == list(want) == ["default", "permute_fwd", "permute_bwd", "ce",
                                       "fused_adam"]
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    for sysc in (port, ref):  # ce_fusion keeps its prior; fused_adam was added
        assert sysc.accelerator.bandwidth["ce_fusion"].efficient_factor == 0.75
    assert {k: (v.gbps, v.efficient_factor) for k, v in port.accelerator.bandwidth.items()} \
        == pytest.approx({k: (v.gbps, v.efficient_factor)
                          for k, v in ref.accelerator.bandwidth.items()})


def test_calibrate_system_writes_a_config_that_loads_back(fixed_timers, tmp_path,
                                                          monkeypatch):
    perf = bench.predict_step(bench.build_bench_model(), "h100_sxm")
    classes = autocal.calibrate_bandwidth_classes(perf.system, nbytes=NBYTES)
    before = perf.analysis_cost()["iter_time"]
    out = tmp_path / "system" / "h100_sxm_test.json"
    out.parent.mkdir()
    measured = autocal.calibrate_system(perf, save_path=str(out), max_keys=4)
    assert sum(len(v) for v in measured.values()) == 4  # fused_adam is a class already
    assert perf.analysis_cost()["iter_time"] != before  # re-estimated
    monkeypatch.setenv("SIMUMAX_TPU_TORCH_CONFIG_ROOT", str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a stale stamp would warn
        loaded = get_system_config("h100_sxm_test")
    assert loaded.config_path == str(out)
    for name, spec in perf.system.accelerator.op.items():
        assert loaded.accelerator.op[name].accurate_efficient_factor == \
            spec.accurate_efficient_factor
    assert {k: v.efficient_factor for k, v in loaded.accelerator.bandwidth.items()} == {
        k: v.efficient_factor for k, v in perf.system.accelerator.bandwidth.items()}
    assert {k: loaded.accelerator.bandwidth[k].efficient_factor for k in classes} == classes
    stamp = json.loads(out.read_text())["provenance"]
    assert stamp == loaded.provenance
    assert stamp["card"] == CARD and stamp["system_hash"] == loaded.fingerprint()
    assert set(stamp) == {"system_hash", "created", "version", "card"}


@pytest.mark.parametrize("listed", [True, False], ids=["calibrated", "datasheet"])
def test_detect_system_prefers_the_calibrated_config(monkeypatch, listed):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    systems = ["h100_sxm", "tpu_v5e_256"] + (["h100_sxm_calibrated"] if listed else [])
    monkeypatch.setattr(bench, "list_configs", lambda: {"system": systems})
    name = "h100_sxm_calibrated" if listed else "h100_sxm"
    assert bench.detect_system() == (name, "NVIDIA H100 80GB HBM3")
    assert bench.base_system() == ("h100_sxm", "NVIDIA H100 80GB HBM3")


def test_committed_calibrated_config_was_measured_on_the_card():
    """``h100_sxm_calibrated`` is ``h100_sxm`` with measured tables: the
    same peaks, every bandwidth class but ``ce_fusion`` and the keys of
    the builder's family measured, and a stamp naming the card."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cal = get_system_config("h100_sxm_calibrated")
    priors = get_system_config("h100_sxm")
    assert cal.sys_name == "h100_sxm_calibrated"
    assert cal.provenance["system_hash"] == cal.fingerprint()
    assert "H100" in cal.provenance["card"] and cal.provenance["card"].endswith(" W")
    assert {k: v.tflops for k, v in cal.accelerator.op.items()} == {
        k: v.tflops for k, v in priors.accelerator.op.items()}
    bw = cal.accelerator.bandwidth
    assert set(bw) == set(priors.accelerator.bandwidth) | {"fused_adam"}
    assert bw["ce_fusion"].efficient_factor == priors.accelerator.bandwidth[
        "ce_fusion"].efficient_factor
    for key in set(bw) - {"ce_fusion"}:
        assert 0 < bw[key].efficient_factor <= autocal.EFF_MAX, key
    # every row of the loop finds its keys in the table
    for _label, kind, seq, mbs, layers, remat in bench.ROWS:
        perf = bench.predict_step(bench.build_model(kind), "h100_sxm_calibrated", kind, seq,
                                  mbs, layers, remat)
        assert not perf.system.miss_efficiency, _label


def test_committed_calibrated_config_records_the_sm_clock_of_each_key_family():
    """The builder samples the SM clock while it times each family of
    keys and the bandwidth classes, and stamps what it read."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cal = get_system_config("h100_sxm_calibrated")
    families = {op for op, spec in cal.accelerator.op.items() if spec.accurate_efficient_factor}
    clocks = cal.provenance["sm_clock"]
    assert set(clocks) == families | {"bandwidth"}
    for family, clock in clocks.items():
        assert clock["samples"] > 0, family
        assert 0 < clock["min_mhz"] <= clock["median_mhz"] <= clock["max_mhz"] \
            <= cal.provenance["max_sm_clock_mhz"], family


def test_build_family_is_the_single_card_members_and_the_rows():
    family = build_system_config.representative_perfs()
    assert len(family) == 8 + len(bench.ROWS)
    assert all(st.world_size == 1 for st, _ in family)
    assert {st.sdp_backend for st, _ in family} == {"torch", "cuda"}
    assert [m.model_name for _, m in family[5:8]] == ["mixtral_8x1b", "mixtral_8x1b",
                                                      "llama3_8b"]


@pytest.mark.parametrize("case", validate_memory_table.CASES,
                         ids=[f"s{c[0]}-L{c[1]}-mbs{c[2]}{'-remat' if c[3] else ''}"
                              for c in validate_memory_table.CASES])
def test_memory_table_predicts_what_jax_predicts(case):
    assert validate_memory_table.CASES == jax_memory_table.CASES
    got = validate_memory_table.predict(*case, "tpu_v5e_256")
    ref = jax_memory_table.predict(*case, "tpu_v5e_256")
    assert got.analysis_mem()["max_peak_bytes"] == pytest.approx(ref, rel=1e-12)
    assert validate.reference_kind(got) == "dense"
    assert got.strategy.enable_recompute is case[3]


@pytest.mark.parametrize("row", bench.ROWS, ids=[r[0] for r in bench.ROWS])
def test_memory_validation_runs_each_rows_own_reference_model(row):
    label, kind, seq, mbs, layers, remat = row
    perf = bench.predict_step(bench.build_model(kind), "h100_sxm", kind, seq, mbs, layers,
                              remat)
    assert validate.reference_kind(perf) == kind


def test_memory_validation_refuses_what_one_card_cannot_run():
    perf = bench.predict_step(bench.build_bench_model(), "tpu_v5e_256")
    perf.strategy.recompute_granularity = "selective_recompute"
    perf.strategy.enable_recompute = True
    with pytest.raises(ValueError, match="full blocks"):
        validate.reference_kind(perf)
    perf.strategy.world_size = 8
    with pytest.raises(ValueError, match="one card"):
        validate.reference_kind(perf)


def test_graph_replays_count_the_launches_they_run():
    """A capture counts nothing (it runs nothing on the card); each replay
    counts every launch it captured."""
    K.reset_launch_counts()
    K.LAUNCHES["flash_fwd"] = 2  # launched before the capture
    before = K.launch_counts()
    K.LAUNCHES["flash_fwd"] += 3  # the wrappers' counts during a capture
    K.LAUNCHES["swiglu_bwd"] += 1
    captured = K.take_launches(before)
    assert captured["flash_fwd"] == 3 and captured["swiglu_bwd"] == 1
    assert K.launch_counts() == before
    K.count_replays(captured, 4)
    assert K.launch_counts()["flash_fwd"] == 14 and K.launch_counts()["swiglu_bwd"] == 4
    K.reset_launch_counts()


def test_new_entry_points_refuse_the_cpu(monkeypatch, tmp_path):
    perf = bench.predict_step(bench.build_bench_model(), "h100_sxm")
    system = perf.system
    for device in ("cuda", "cpu"):
        for call in (
            lambda: autocal.measure_bandwidth_efficiency("default", 3350.0, device=device),
            lambda: autocal.measure_bandwidth_efficiency("fused_adam", 3350.0, device=device),
            lambda: autocal.calibrate_bandwidth_classes(system, device=device),
            lambda: autocal.calibrate_system(perf, str(tmp_path / "x.json"), device=device),
            lambda: autocal.card_identity(device=device),
            lambda: validate.validate_memory(perf, device=device),
        ):
            if device == "cuda":
                monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
                match = "no CUDA device"
            else:
                match = "CUDA card"
            with pytest.raises(RuntimeError, match=match):
                call()
            monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: timing.time_graph(lambda: None),
        lambda: build_system_config.build(str(tmp_path / "y.json")),
        lambda: validate_memory_table.run(),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not (tmp_path / "x.json").exists() and not (tmp_path / "y.json").exists()
    assert "fused_adam" not in system.accelerator.bandwidth
