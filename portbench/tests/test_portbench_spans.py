"""The attribution of device events to the program's spans on synthetic
traces: the spans nested inside ``gemm``, backward kernels by sequence
number and on autograd's thread, the step's phases across two threads,
the trace found by the cell's contents, the self-check against the run's
own family reading, and each new reader's arithmetic."""

import json
import os

import pytest

from portbench import manifest, spans, trace, work
from portbench.weights import Model

DENSE = Model(kind="dense", vocab=10, hidden=4, heads=2, kv_heads=1, head_dim=2, layers=3,
              ffn=6, rope_theta=1e4, eps=1e-5)
MOE = Model(kind="moe", vocab=10, hidden=4, heads=2, kv_heads=1, head_dim=2, layers=2, ffn=3,
            rope_theta=1e4, eps=1e-5,
            own=manifest.load_kind("moe").Own(experts=4, topk=2, capacity_factor=2.0))


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _op(name, ts, dur, tid=1, seq=None, fwd_tid=1):
    args = {} if seq is None else {"Sequence number": seq, "Fwd thread id": fwd_tid}
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _step_window():
    """A mark, then one step on thread 1 (``step`` [100, 1000)): its
    ``forward`` [110, 500) holds an int8 product inside ``gemm`` (a custom
    Function's forward op, sequence number 9, with ``q8`` and ``int8_mm``
    inside) and an MoE expert ``bmm`` inside ``gemm`` and ``expert_gemm``
    (sequence number 7), then an elementwise op; its ``backward`` [500,
    900) waits while autograd's thread 2 runs the custom Function's
    backward (an ``int8_mm`` and a ``q8`` span, and a copy outside any
    span) and the native backward of op 7; the optimizer runs after it."""
    return [
        _kernel("spin_kernel", 0, 10, 1),
        _range(spans.STEP, 100, 900),
        _range("forward", 110, 390),
        _range("gemm", 120, 60),
        _op("_Int8Matmul", 121, 55, seq=9),
        _range("q8", 122, 10),
        _launch(125, 10),
        _kernel("q8_amax_kernel", 200, 5, 10),
        _range("int8_mm", 140, 10),
        _op("aten::_int_mm", 141, 8),
        _launch(142, 11),
        _kernel("cutlass_i8_gemm", 210, 40, 11),
        _launch(160, 12),  # in gemm, in no span inside it
        _kernel("gemm_epilogue_copy", 260, 5, 12),
        _range("gemm", 300, 50),
        _range("expert_gemm", 301, 45),
        _op("aten::bmm", 305, 30, seq=7),
        _launch(310, 13),
        _kernel("sm90_bmm", 270, 30, 13),
        _op("aten::add", 400, 10, seq=8),
        _launch(402, 14),
        _kernel("elementwise_add", 300, 10, 14),
        _range("backward", 500, 400),
        # autograd's device thread
        _op(trace._BACKWARD + "_Int8MatmulBackward", 510, 100, tid=2, seq=9),
        _op("_Int8MatmulBackward", 511, 98, tid=2),
        _range("q8", 515, 20, tid=2),
        _launch(520, 20, tid=2),
        _kernel("q8_quantize_rows_kernel", 520, 7, 20),
        _range("int8_mm", 540, 20, tid=2),
        _launch(545, 21, tid=2),
        _kernel("cutlass_i8_gemm", 530, 60, 21),
        _launch(570, 22, tid=2),  # the backward's reshape copy: the forward op's range
        _kernel("copy_kernel", 600, 3, 22),
        _op(trace._BACKWARD + "BmmBackward0", 700, 50, tid=2, seq=7),
        _launch(705, 23, tid=2),
        _kernel("sm90_bmm_bwd", 610, 50, 23),
        _range("optimizer", 910, 50),
        _launch(915, 30),
        _kernel("adam_multi_tensor_kernel", 700, 20, 30),
    ]


def test_the_spans_inside_gemm_take_their_kernels():
    got = spans.read_events(_step_window())
    assert got["steps"] == 1
    assert got["region_ms"] == pytest.approx({
        "q8": (5 + 7) / 1e3,  # the forward's amax, the backward's quantize
        "int8_mm": (40 + 60) / 1e3,  # forward and the custom backward on thread 2
        "gemm": (5 + 3) / 1e3,  # in gemm, in none of its spans
        "expert_gemm": (30 + 50) / 1e3,  # the bmm and its native backward by sequence number
        trace.ELEMENTWISE: 10 / 1e3,
        "optimizer": 20 / 1e3,
    })


def test_the_spans_are_transparent_to_the_family_reading():
    """:mod:`trace`'s reading, which skips the new spans, puts every kernel
    in the spans' enclosing family: the self-check folds them back."""
    window = _step_window()
    frozen = trace.read_window(window, steps=1)["family_ms"]
    assert frozen["gemm"] == pytest.approx((5 + 7 + 40 + 60 + 5 + 3 + 30 + 50) / 1e3)
    assert spans.matches(spans.read_events(window), frozen)
    # the same host ops with and without the span events: the same families
    bare = [e for e in window if e.get("name") not in spans.GEMM_PARTS + spans.PHASES
            + (spans.STEP,)]
    assert trace.read_window(bare, steps=1)["family_ms"] == frozen


def test_phases_count_the_launches_of_any_thread():
    got = spans.read_events(_step_window())
    # forward: amax, int8 product, epilogue copy, bmm, add; backward: thread
    # 2's quantize, product, copy and bmm backward; Adam in neither
    assert got["phase_ms"]["forward"] == pytest.approx((5 + 40 + 5 + 30 + 10) / 1e3)
    assert got["phase_ms"]["backward"] == pytest.approx((7 + 60 + 3 + 50) / 1e3)
    assert got["step_host_ms"] == pytest.approx(900 / 1e3)


def test_steps_divide_and_the_host_time_is_the_mean():
    one = _step_window()
    second = [dict(e, ts=e["ts"] + 2000) for e in one[1:]]
    for e in second:  # fresh correlation ids
        if "correlation" in e.get("args", {}):
            e["args"] = {"correlation": e["args"]["correlation"] + 100}
    second[0]["dur"] = 1100  # the second step's span
    got = spans.read_events(one + second)
    assert got["steps"] == 2
    assert got["step_host_ms"] == pytest.approx((900 + 1100) / 2 / 1e3)
    assert got["region_ms"]["int8_mm"] == pytest.approx((40 + 60) / 1e3)


def test_a_window_without_a_step_span_reads_nothing():
    assert spans.read_events([e for e in _step_window() if e["name"] != spans.STEP]) is None
    assert spans.read_events([e for e in _step_window() if e["name"] != "spin_kernel"]) is None


def _bench(tmp_path, cells):
    (tmp_path / "cells").mkdir()
    for name, cell in cells.items():
        (tmp_path / "cells" / f"{name}.json").write_text(json.dumps(cell, indent=1))
    (tmp_path / "traces").mkdir()
    return str(tmp_path), str(tmp_path / "traces")


def test_the_trace_is_found_by_the_cells_contents(tmp_path):
    a, b = {"config": "x", "seq": 8}, {"config": "x", "seq": 16}
    bench, traces = _bench(tmp_path, {"x.a": a, "x.b": b})
    assert spans.trace_path(a, bench, traces) is None  # no trace written yet
    (tmp_path / "traces" / "x.a.json").write_text("[]")
    assert spans.trace_path(a, bench, traces) == str(tmp_path / "traces" / "x.a.json")
    assert spans.trace_path(b, bench, traces) is None


def test_a_cell_no_file_holds_takes_the_newest_trace(tmp_path):
    """A cell built in code (the tests' tiny cells) takes the newest trace,
    which the self-check still has to confirm."""
    bench, traces = _bench(tmp_path, {"x.a": {"config": "x", "seq": 8}})
    tiny = {"config": "x", "seq": 2}
    assert spans.trace_path(tiny, bench, traces) is None
    for age, name in ((200, "x.a.json"), (100, "x.b.json")):
        path = tmp_path / "traces" / name
        path.write_text("[]")
        os.utime(path, (path.stat().st_atime, path.stat().st_mtime - age))
    assert spans.trace_path(tiny, bench, traces) == str(tmp_path / "traces" / "x.b.json")


def test_two_cells_of_the_same_contents_name_no_trace(tmp_path):
    a = {"config": "x", "seq": 8}
    bench, traces = _bench(tmp_path, {"x.a": a, "x.b": a})
    (tmp_path / "traces" / "x.a.json").write_text("[]")
    assert spans.trace_path(a, bench, traces) is None


def test_read_checks_itself_against_the_family_reading(tmp_path):
    cell = {"config": "x", "seq": 8}
    bench, traces = _bench(tmp_path, {"x.a": cell})
    window = _step_window()
    (tmp_path / "traces" / "x.a.json").write_text(json.dumps({"traceEvents": window}))
    family_ms = trace.read_window(window, steps=1)["family_ms"]
    record = {"cell": cell, "traced": {"family_ms": family_ms}}
    got = spans.read(record, bench, traces)
    assert got["region_ms"]["int8_mm"] == pytest.approx(0.1)
    off = dict(family_ms, gemm=family_ms["gemm"] * 1.002)
    assert spans.read({"cell": cell, "traced": {"family_ms": off}}, bench, traces) is None
    moved = dict(family_ms, optimizer=0.0, elementwise=family_ms["elementwise"] + 0.02)
    assert spans.read({"cell": cell, "traced": {"family_ms": moved}}, bench, traces) is None
    # within a tenth of a percent
    near = {f: ms * (1 + 5e-4) for f, ms in family_ms.items()}
    assert spans.read({"cell": cell, "traced": {"family_ms": near}}, bench, traces) is not None
    # a run on the CPU: no trace
    assert spans.read({"cell": cell, "traced": None}, bench, traces) is None


READERS = ("int8_mm_roofline", "q8_roofline", "expert_gemm_roofline", "backward_over_forward",
           "host_issue_ms")


def _with_spans(monkeypatch, got):
    monkeypatch.setattr(spans, "read", lambda record: got)


def test_q8_bytes_by_hand():
    # 16 tokens, 10 B for each element of x, w and y of every product:
    # qkv 16*4 + 4*8 + 16*8 = 224, out 64 + 16 + 64 = 144, up 64 + 48 + 192
    # = 304, down 96 + 24 + 64 = 184 (856 a layer, 3 layers); LM head 64 +
    # 40 + 160 = 264
    q8 = manifest.load_reader("q8_roofline")
    assert q8.q8_bytes(DENSE, 16) == 10 * (3 * 856 + 264)


def test_the_roofline_readers_by_hand(monkeypatch):
    record = {"model": DENSE, "mbs": 2, "seq": 8, "linear": "int8"}
    int8_ideal_ms = work.gemm_ideal_s(DENSE, 16, "int8") * 1e3
    q8_ideal_ms = 28320 / 3.35e12 * 1e3
    _with_spans(monkeypatch, {"region_ms": {"int8_mm": 4 * int8_ideal_ms, "q8": 2 * q8_ideal_ms}})
    assert manifest.load_reader("int8_mm_roofline").read(record) == pytest.approx(25.0)
    assert manifest.load_reader("q8_roofline").read(record) == pytest.approx(50.0)
    assert manifest.load_reader("expert_gemm_roofline").read(record) is None
    # the experts' routed rows: 16 tokens x top-2 = 32 of each product,
    # bytes-bound at these widths: up 2 (32*4 + 4*4*6 + 32*6) = 832 B,
    # down 2 (32*3 + 4*3*4 + 32*4) = 544 B, three products each, two layers
    moe = {"model": MOE, "mbs": 2, "seq": 8, "linear": "bf16"}
    ideal_ms = 2 * 3 * (832 + 544) / 3.35e12 * 1e3
    _with_spans(monkeypatch, {"region_ms": {"expert_gemm": 5 * ideal_ms}})
    assert manifest.load_reader("expert_gemm_roofline").read(moe) == pytest.approx(20.0)


def test_the_step_readers_by_hand(monkeypatch):
    _with_spans(monkeypatch, {"phase_ms": {"forward": 40.0, "backward": 90.0},
                              "step_host_ms": 12.5, "region_ms": {}})
    assert manifest.load_reader("backward_over_forward").read({}) == pytest.approx(2.25)
    assert manifest.load_reader("host_issue_ms").read({}) == pytest.approx(12.5)


@pytest.mark.parametrize("name", READERS)
def test_a_span_reader_with_nothing_to_read_is_left_out(monkeypatch, name):
    record = {"model": DENSE, "mbs": 2, "seq": 8, "linear": "int8", "cell": {}, "traced": None}
    assert manifest.load_reader(name).read(record) is None
    _with_spans(monkeypatch, None)
    assert manifest.load_reader(name).read(record) is None
