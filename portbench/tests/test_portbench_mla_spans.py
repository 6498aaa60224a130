"""The latent-attention MoE model's spans on synthetic traces
(``portbench/mla_spans.py``): ``mla_proj`` and ``shared_expert`` inside
``gemm`` and ``route`` inside ``moe_dispatch`` take their kernels, a
backward kernel by its forward op's sequence number on autograd's thread;
the reading checks itself by folding them back into the run's family
reading; the three readers' arithmetic; a trace without the spans (a
program that predates them) reads nothing."""

import json
import os

import pytest

from portbench import manifest, mla_spans, spans, trace
from portbench.tests.test_portbench_spans import _bench, _kernel, _launch, _op, _range

KIND = manifest.load_kind("mla_moe")
CONFIG = manifest.read_json(os.path.join(manifest.BENCH_DIR, "configs", "moonlight-16b-a3b.json"))
READERS = ("mla_proj_roofline", "shared_expert_roofline", "route_roofline")


def _window():
    """A mark, then one step on thread 1 (``step`` [100, 1000)): its
    ``forward`` holds a latent projection inside ``gemm`` and ``mla_proj``
    (sequence number 3), the output projection in ``gemm`` alone, a shared
    expert's product inside ``gemm`` and ``shared_expert`` (4), the router
    product and the route kernel inside ``moe_dispatch`` and ``route`` (5),
    the dispatch in ``moe_dispatch`` alone, then an elementwise op; its
    ``backward`` waits while autograd's thread 2 runs the native backwards
    of ops 3, 4 and 5; the optimizer runs after it."""
    return [
        _kernel("spin_kernel", 0, 10, 1),
        _range(spans.STEP, 100, 900),
        _range("forward", 110, 390),
        _range("gemm", 120, 40),
        _range("mla_proj", 121, 30),
        _op("aten::mm", 122, 20, seq=3),
        _launch(125, 10),
        _kernel("nvjet_q_proj", 200, 20, 10),
        _launch(155, 11),  # in gemm, in no span inside it: the output projection
        _kernel("nvjet_o_proj", 230, 8, 11),
        _range("gemm", 170, 30),
        _range("shared_expert", 171, 25),
        _op("aten::mm", 172, 20, seq=4),
        _launch(175, 12),
        _kernel("nvjet_shared_up", 250, 12, 12),
        _range("moe_dispatch", 210, 60),
        _range("route", 211, 40),
        _op("aten::mm", 212, 15, seq=5),
        _launch(214, 13),
        _kernel("sgemm_router", 270, 6, 13),
        _launch(240, 14),
        _kernel("moe_route_sigmoid_fwd_kernel", 280, 2, 14),
        _launch(260, 15),  # the dispatch: moe_dispatch, in no span inside it
        _kernel("moe_permute_fwd_kernel", 290, 3, 15),
        _op("aten::add", 400, 10, seq=8),
        _launch(402, 16),
        _kernel("elementwise_add", 300, 4, 16),
        _range("backward", 500, 400),
        _op(trace._BACKWARD + "MmBackward0", 510, 50, tid=2, seq=3),
        _launch(515, 20, tid=2),
        _kernel("nvjet_q_proj_dgrad", 520, 40, 20),
        _op(trace._BACKWARD + "MmBackward0", 600, 50, tid=2, seq=4),
        _launch(605, 21, tid=2),
        _kernel("nvjet_shared_up_dgrad", 580, 24, 21),
        _op(trace._BACKWARD + "MmBackward0", 700, 50, tid=2, seq=5),
        _launch(705, 22, tid=2),
        _kernel("sgemm_router_dgrad", 610, 12, 22),
        _range("optimizer", 910, 50),
        _launch(915, 30),
        _kernel("adam_multi_tensor_kernel", 700, 20, 30),
    ]


def test_the_new_spans_take_their_kernels():
    got = mla_spans.read_events(_window())
    assert got["steps"] == 1
    assert got["region_ms"] == pytest.approx({
        "mla_proj": (20 + 40) / 1e3,  # the forward product and its backward by sequence number
        "gemm": 8 / 1e3,  # the output projection: gemm, in none of its spans
        "shared_expert": (12 + 24) / 1e3,
        "route": (6 + 2 + 12) / 1e3,  # the router product, the route kernel, the dgrad
        "moe_dispatch": 3 / 1e3,
        trace.ELEMENTWISE: 4 / 1e3,
        "optimizer": 20 / 1e3,
    })


def test_the_spans_fold_back_into_the_family_reading():
    """:mod:`trace`'s reading puts every kernel of the new spans in their
    enclosing family, and the self-check folds them back; the spans of
    :mod:`spans` read the same families without them."""
    window = _window()
    frozen = trace.read_window(window, steps=1)["family_ms"]
    assert frozen["gemm"] == pytest.approx((20 + 40 + 8 + 12 + 24) / 1e3)
    assert frozen["moe_dispatch"] == pytest.approx((6 + 2 + 12 + 3) / 1e3)
    got = mla_spans.read_events(window)
    assert mla_spans.matches(got, frozen)
    assert not mla_spans.matches(got, dict(frozen, moe_dispatch=frozen["moe_dispatch"] * 1.01))
    # moving route's time to gemm keeps the total, not the families
    moved = dict(got["region_ms"], route=0.0, mla_proj=got["region_ms"]["mla_proj"]
                 + got["region_ms"]["route"])
    assert not mla_spans.matches({"region_ms": moved}, frozen)
    assert spans.matches(spans.read_events(window), frozen)


def test_read_checks_itself_and_finds_nothing_without_the_spans(tmp_path):
    cell = {"config": "moonlight-16b-a3b", "seq": 8}
    bench, traces = _bench(tmp_path, {"m.a": cell})
    window = _window()
    (tmp_path / "traces" / "m.a.json").write_text(json.dumps({"traceEvents": window}))
    family_ms = trace.read_window(window, steps=1)["family_ms"]
    got = mla_spans.read({"cell": cell, "traced": {"family_ms": family_ms}}, bench, traces)
    assert got["region_ms"]["route"] == pytest.approx(0.02)
    off = dict(family_ms, gemm=family_ms["gemm"] * 1.002)
    assert mla_spans.read({"cell": cell, "traced": {"family_ms": off}}, bench, traces) is None
    assert mla_spans.read({"cell": cell, "traced": None}, bench, traces) is None
    # a program without the new spans: its trace reads, but no region is new
    bare = [e for e in window if e.get("name") not in mla_spans.PARTS]
    (tmp_path / "traces" / "m.a.json").write_text(json.dumps({"traceEvents": bare}))
    got = mla_spans.read({"cell": cell, "traced": {"family_ms": family_ms}}, bench, traces)
    assert got is not None and not set(got["region_ms"]) & set(mla_spans.PARTS)


def _moonlight(**over):
    from portbench.weights import Model

    return Model.from_config(dict(CONFIG, **over))


def test_the_readers_by_hand(monkeypatch):
    """Each reader's ideal over the span's device ms: the latent path's
    three products in all 27 layers, the shared experts' two in the 26
    expert layers, and the route's float32 products and bytes."""
    m = _moonlight()
    record = {"model": m, "mbs": 1, "seq": 8192, "linear": "bf16"}
    tokens = 8192
    # q 2048 -> 3072, kv_a 2048 -> 576, kv_b 512 -> 4096: compute-bound at
    # 8192 rows, 3 products of 2 rows k n each
    mla_ideal_ms = 27 * 3 * 2 * tokens * (2048 * 3072 + 2048 * 576 + 512 * 4096) / 989e12 * 1e3
    shared_ideal_ms = 26 * 3 * 2 * tokens * (2048 * 5632 + 2816 * 2048) / 989e12 * 1e3
    route_ideal_ms = KIND.route_ideal_s(m, tokens) * 1e3
    # the router's products dominate: 3 x 2 x 8192 x 2048 x 64 a layer at 67 TFLOP/s
    assert route_ideal_ms == pytest.approx(26 * 6 * tokens * 2048 * 64 / 67e12 * 1e3, rel=0.05)
    regions = {"mla_proj": 2 * mla_ideal_ms, "shared_expert": 4 * shared_ideal_ms,
               "route": 5 * route_ideal_ms}
    monkeypatch.setattr(mla_spans, "read", lambda record: {"region_ms": regions})
    assert manifest.load_reader("mla_proj_roofline").read(record) == pytest.approx(50.0)
    assert manifest.load_reader("shared_expert_roofline").read(record) == pytest.approx(25.0)
    assert manifest.load_reader("route_roofline").read(record) == pytest.approx(20.0)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_nothing_to_read_is_left_out(monkeypatch, name):
    record = {"model": _moonlight(), "mbs": 1, "seq": 8192, "linear": "bf16", "cell": {},
              "traced": None}
    assert manifest.load_reader(name).read(record) is None
    monkeypatch.setattr(mla_spans, "read", lambda record: None)
    assert manifest.load_reader(name).read(record) is None
    monkeypatch.setattr(mla_spans, "read", lambda record: {"region_ms": {"gemm": 5.0}})
    assert manifest.load_reader(name).read(record) is None
