"""The port's profiler spans (``simumax_tpu_torch/torchref/spans.py``) in
CPU profiles of small training steps: ``int8_mm`` and ``q8`` inside
``gemm`` in the int8 products (single-device and on local shards),
``expert_gemm`` around the MoE experts' products, ``mla_proj`` and
``shared_expert`` inside ``gemm`` and ``route`` inside ``moe_dispatch`` in
the latent-attention MoE model, one ``step`` a step holding its
``forward``, ``backward`` and ``optimizer``; the benchmark's family reading
unmoved by the new spans; and no ``record_function`` entered while no
profiler runs."""

import json

import pytest

torch = pytest.importorskip("torch")

from portbench import mla_spans  # noqa: E402
from portbench import spans as pb_spans  # noqa: E402
from portbench import trace  # noqa: E402
from simumax_tpu_torch.torchref import mla_moe_model as MLA  # noqa: E402
from simumax_tpu_torch.torchref import model as M  # noqa: E402
from simumax_tpu_torch.torchref import moe_model as MoE  # noqa: E402
from simumax_tpu_torch.torchref import quantized as Q  # noqa: E402
from simumax_tpu_torch.torchref import spans  # noqa: E402

#: the marker each q8 kernel wrapper's call leaves in a profile here
Q8_CALL = "test_q8_call"
#: the marker each call of the int8 path's GEMM (``kernels.int8_gemm``)
#: leaves in a profile here
GEMM_CALL = "test_int8_gemm_call"


def _dense(use_int8: bool, layers: int = 1):
    cfg = M.LlamaConfig(vocab_size=256, hidden_size=64, head_num=2, kv_head_num=1,
                        head_size=32, intermediate_size=128, layer_num=layers,
                        dtype=torch.bfloat16, use_int8=use_int8)
    params = M.init_params(cfg, seed=0, device="cpu")
    init_opt, step = M.make_train_step(cfg)
    return cfg, params, init_opt(params), step


def _moe():
    cfg = MoE.MoeConfig(vocab_size=256, hidden_size=64, head_num=2, kv_head_num=2,
                        head_size=32, layer_num=2, expert_num=4, topk=2, moe_ffn=64,
                        dtype=torch.float32)
    params = MoE.init_params(cfg, seed=0, device="cpu")
    init_opt, step = MoE.make_train_step(cfg)
    return cfg, params, init_opt(params), step


def _mla():
    cfg = MLA.MlaMoeConfig(vocab_size=256, hidden_size=64, num_attention_heads=2,
                           kv_lora_rank=32, num_hidden_layers=3, intermediate_size=128,
                           moe_intermediate_size=32, n_routed_experts=16, experts_held=(4, 4),
                           correction_bias_std=0.05, dtype=torch.float32, use_flash_attn=True)
    params = MLA.init_params(cfg, seed=0, device="cpu")
    init_opt, step = MLA.make_train_step(cfg)
    return cfg, params, init_opt(params), step


def _ids():
    return torch.randint(0, 256, (1, 32), generator=torch.Generator().manual_seed(0))


def _profile(fn, path):
    """The complete host events of one profiled call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    return [e for e in events if e.get("ph") == "X"]


def _step_events(make, path, steps=1):
    _cfg, params, opt, step = make()
    ids = _ids()
    return _profile(lambda: [step(params, opt, (ids, ids)) for _ in range(steps)], path)


def _ranges(events, name):
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name]


def _ops(events, name):
    return [e for e in events if e.get("cat") == "cpu_op" and e["name"] == name]


def _within(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner.get("dur", 0) <= outer["ts"] + outer.get("dur", 0))


def _inside(inner, ranges) -> bool:
    return any(_within(inner, r) for r in ranges)


def _in_gemm(events, ranges) -> bool:
    """Whether the benchmark's family reading puts each of ``ranges`` in
    ``gemm``: inside its range in the forward, through the forward op's
    sequence number in the backward."""
    queries = [(r["tid"], r["ts"] + r.get("dur", 0) / 2) for r in ranges]
    return set(trace.host_families(events, queries)) == {"gemm"}


@pytest.fixture
def gemm_marked(monkeypatch):
    """The int8 GEMM's wrapper, as ``quantized.py`` calls it, each call
    marked by a :data:`GEMM_CALL` range."""
    fn = Q.int8_gemm

    def marked(*args, **kwargs):
        with torch.profiler.record_function(GEMM_CALL):
            return fn(*args, **kwargs)

    monkeypatch.setattr(Q, "int8_gemm", marked)


@pytest.fixture
def q8_marked(monkeypatch):
    """The q8 kernels' wrappers, as ``quantized.py`` calls them, each call
    marked by a :data:`Q8_CALL` range."""
    for name in ("q8_amax", "q8_quantize", "q8_dequant"):
        fn = getattr(Q, name)

        def marked(*args, _fn=fn, **kwargs):
            with torch.profiler.record_function(Q8_CALL):
                return _fn(*args, **kwargs)

        monkeypatch.setattr(Q, name, marked)


def test_each_int_mm_runs_in_an_int8_mm_span_inside_gemm(tmp_path, gemm_marked):
    events = _step_events(lambda: _dense(True), tmp_path / "t.json")
    products = 4 + 1  # qkv, out, up, down and the LM head
    int_mm, int8_mm = _ranges(events, GEMM_CALL), _ranges(events, "int8_mm")
    assert len(int_mm) == len(int8_mm) == 3 * products  # forward, dgrad, wgrad
    assert all(_inside(e, int8_mm) for e in int_mm)
    assert _in_gemm(events, int8_mm)
    assert sum(_inside(r, _ranges(events, "gemm")) for r in int8_mm) == products


def test_each_q8_call_runs_in_a_q8_span_inside_gemm(tmp_path, q8_marked):
    events = _step_events(lambda: _dense(True), tmp_path / "t.json")
    calls, q8 = _ranges(events, Q8_CALL), _ranges(events, "q8")
    # forward: x and w quantized, y dequantized; backward: g, w and x
    # quantized, dx and dw dequantized (amax with its quantize in one span)
    assert len(q8) == 8 * 5
    assert len(calls) == (2 * 2 + 1 + 3 * 2 + 2) * 5
    assert all(_inside(e, q8) for e in calls)
    assert _in_gemm(events, q8)
    assert not any(_inside(r, _ranges(events, "int8_mm")) for r in q8)


def test_the_product_on_local_shards_has_the_same_spans(tmp_path, q8_marked, gemm_marked):
    """``int8_matmul_sharded`` with no mesh axis (its one-rank case, which
    needs no process group), inside a ``gemm`` range as the DTensor step
    calls it."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 64, generator=gen).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(64, 48, generator=gen).to(torch.bfloat16).requires_grad_(True)

    def product():
        with spans.op_family("gemm"):
            y = Q.int8_matmul_sharded(x, w, None, Q.Int8Split())
        y.float().square().sum().backward()

    events = _profile(product, tmp_path / "t.json")
    calls, q8, int8_mm = (_ranges(events, Q8_CALL), _ranges(events, "q8"),
                          _ranges(events, "int8_mm"))
    assert len(int8_mm) == len(_ranges(events, GEMM_CALL)) == 3
    assert calls and all(_inside(e, q8) for e in calls)
    forward = [r for r in q8 + int8_mm if _inside(r, _ranges(events, "gemm"))]
    assert len(forward) == 5 + 1  # amax x and w, quantize x and w, dequantize; the product


def test_each_expert_product_runs_in_an_expert_gemm_span_inside_gemm(tmp_path):
    events = _step_events(_moe, tmp_path / "t.json")
    expert = _ranges(events, "expert_gemm")
    assert len(expert) == 2 * 2  # up and down, two layers
    assert all(_inside(r, _ranges(events, "gemm")) for r in expert)
    forward_bmm = [e for e in _ops(events, "aten::bmm") if "Sequence number" in e["args"]]
    in_expert = [e for e in forward_bmm if _inside(e, expert)]
    assert len(in_expert) == 4  # each expert span holds its one bmm
    assert all(sum(_within(e, r) for e in in_expert) == 1 for r in expert)
    # math attention's products stay outside them
    assert len(forward_bmm) > len(in_expert)
    # the benchmark's span reading: the forward products and the two of
    # each one's native backward, by its sequence number
    bmm = _ops(events, "aten::bmm")
    regions = pb_spans.host_regions(events, [(e["tid"], e["ts"] + e["dur"] / 2) for e in bmm])
    assert regions.count("expert_gemm") == 4 * 3
    assert set(regions) == {"expert_gemm", "attention"}


@pytest.mark.parametrize("make", [lambda: _dense(False), lambda: _dense(True), _moe, _mla],
                         ids=["bf16", "int8", "moe", "mla_moe"])
def test_one_step_span_a_step_holds_its_phases(make, tmp_path):
    events = _step_events(make, tmp_path / "t.json", steps=2)
    step = _ranges(events, "step")
    assert len(step) == 2
    for s in step:
        fwd = [r for r in _ranges(events, "forward") if _within(r, s)]
        bwd = [r for r in _ranges(events, "backward") if _within(r, s)]
        opt = [r for r in _ranges(events, "optimizer") if _within(r, s)]
        assert len(fwd) == len(bwd) == 1 and opt
        assert fwd[0]["ts"] + fwd[0]["dur"] <= bwd[0]["ts"]
        assert all(bwd[0]["ts"] + bwd[0]["dur"] <= r["ts"] for r in opt)
        # the loss's forward ranges lie in the forward phase
        assert [r for r in _ranges(events, "cross_entropy") if _within(r, fwd[0])]


@pytest.mark.parametrize("make", [lambda: _dense(False), lambda: _dense(True), _moe, _mla],
                         ids=["bf16", "int8", "moe", "mla_moe"])
def test_the_benchmark_reads_the_same_families_with_the_new_spans(make, tmp_path):
    """``portbench/trace.py`` skips the ranges it does not know: each host
    op lands in the same family with the new spans as without them."""
    events = _step_events(make, tmp_path / "t.json")
    new = set(spans.SPANS) - set(spans.OP_FAMILIES)
    bare = [e for e in events if not (e.get("cat") == "user_annotation" and e["name"] in new)]
    assert len(bare) < len(events)
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    queries = [(e["tid"], e["ts"] + e.get("dur", 0) / 2) for e in ops]
    with_spans = trace.host_families(events, queries)
    assert with_spans == trace.host_families(bare, queries)
    assert "gemm" in with_spans


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        if name in spans.SPANS:
            entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    ids = _ids()
    for make in (lambda: _dense(True), _moe, _mla):
        _cfg, params, opt, step = make()
        step(params, opt, (ids, ids))
    with spans.span("step"), spans.op_family("gemm"):
        pass
    assert entered == []
    # the same calls under a profiler enter it
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("step"), spans.op_family("gemm"):
            pass
    assert entered == ["step", "gemm"]


def test_the_latent_attention_moe_step_has_its_spans_inside_their_families(tmp_path):
    """``mla_proj`` around the three latent projections of each layer and
    ``shared_expert`` around the shared experts' two products of each
    expert layer, inside ``gemm``; ``route`` around each expert layer's
    router product, route and index, inside ``moe_dispatch``; the
    benchmark's reading of them (``portbench/mla_spans.py``) takes the
    forward products and, by sequence number, their backwards."""
    events = _step_events(_mla, tmp_path / "t.json")
    mla_proj, shared, route = (_ranges(events, n) for n in ("mla_proj", "shared_expert", "route"))
    assert len(mla_proj) == 2 * 3  # (q_proj with kv_a_proj_with_mqa, kv_b_proj) a layer
    assert len(shared) == 2 * 2 and len(route) == 2  # two expert layers
    assert all(_inside(r, _ranges(events, "gemm")) for r in mla_proj + shared)
    assert all(_inside(r, _ranges(events, "moe_dispatch")) for r in route)
    mm = [e for e in _ops(events, "aten::mm") if "Sequence number" in e["args"]]
    in_mla = [e for e in mm if _inside(e, mla_proj)]
    in_shared = [e for e in mm if _inside(e, shared)]
    in_route = [e for e in mm if _inside(e, route)]
    assert (len(in_mla), len(in_shared), len(in_route)) == (3 * 3, 2 * 2, 2)
    ops = _ops(events, "aten::mm")
    regions = pb_spans.host_regions(events, [(e["tid"], e["ts"] + e["dur"] / 2) for e in ops],
                                    mla_spans.REGIONS)
    # each forward product and the two of its backward (dgrad and wgrad)
    assert regions.count("mla_proj") == 3 * 9
    assert regions.count("shared_expert") == 3 * 4
    assert regions.count("route") == 3 * 2
    # portbench/spans.py, which knows none of them, puts the same ops in
    # the enclosing families
    base = pb_spans.host_regions(events, [(e["tid"], e["ts"] + e["dur"] / 2) for e in ops])
    for new, old in zip(regions, base):
        assert old == mla_spans.PARTS.get(new, new)


def test_span_names_are_checked():
    with pytest.raises(ValueError, match="unknown span"):
        spans.span("gemms")
    with pytest.raises(ValueError, match="unknown op family"):
        spans.op_family("q8")
    assert M.OP_FAMILIES == spans.OP_FAMILIES == trace.SPANS
    assert M.op_family is spans.op_family
