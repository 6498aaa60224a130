"""The latent-attention MoE model (``torchref/mla_moe_model.py``,
Moonlight-16B-A3B's block) against the benchmark's plain float32 reference
(``portbench/kinds/mla_moe.py``) at a small size on the CPU, on seeded
random weights: the loss and every leaf's gradient, an Adam step and the
next loss, in fp32 and bf16; the routing assignment for assignment; the
flash kernels' plain versions at the (192, 128) head pair; the sigmoid
route's gradient and the bias that gets none; the index of held experts;
and the shares of the experts adding up to the uncut layer."""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

from portbench import compare, manifest, reference, weights  # noqa: E402
from simumax_tpu_torch.torchref import kernels as K  # noqa: E402
from simumax_tpu_torch.torchref import mla_moe_model as M  # noqa: E402

KIND = manifest.load_kind("mla_moe")
CONFIG = manifest.read_json(os.path.join(manifest.BENCH_DIR, "configs",
                                         "moonlight-16b-a3b.json"))
#: Moonlight's block at a small size: its head widths (the flash pair 192 /
#: 128), 16 routed experts of which 4 are held, 6 a token, a dense first
#: layer and two expert layers
SIZES = {"hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
         "num_attention_heads": 2, "kv_lora_rank": 32, "num_hidden_layers": 3,
         "vocab_size": 128, "n_routed_experts": 4, "experts_held": [4, 4],
         "published": {"n_routed_experts": 16, "vocab_size": 163840}}
SEED = 2147483659
OPT = CONFIG["optimizer"]


def _model(**over):
    return weights.Model.from_config(dict(CONFIG, **dict(SIZES, **over)))


def _port(m, dtype):
    return M.MlaMoeConfig(**KIND.port_fields(m), dtype=dtype)


def _params(m, dtype):
    """The harness's weights from the seed (bf16), in ``dtype``."""
    params = weights.make_params(m, SEED, "cpu")
    return _map(params, lambda t: t.detach().to(dtype).requires_grad_(True))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _batch(m, seed=SEED):
    return weights.make_batches(seed, 2, 2, 64, m.vocab, "cpu")


def _rel(a, b) -> float:
    """||a - b|| / ||b||."""
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


#: the leaves a route near a tie moves: the router's and the held experts'
ROUTED = ("router", "experts_up", "experts_down")
#: relative gaps, program against reference. fp32: the two sides add in
#: other orders (rms norms, attention, the combine) and take RoPE's angles
#: in fp32 against float64: the loss within 1e-6 and every gradient, and an
#: Adam step's change of every leaf, within 2e-5 of its norm (read: 9e-8,
#: 2.2e-6). bf16: the program rounds activations and weights to bf16 (8
#: bits of mantissa) at every product and norm, and at the tests' 128
#: tokens a route near a tie flips between bf16 and float32 and moves its
#: expert's rows and the router's column, and through them the gradients
#: of the norms and projections before: the loss within 5e-3, a routed
#: leaf's gradient within 0.4 and any other's within 0.2 (read on 6 seeds,
#: 1.2e-3, 0.22, 0.11); after two Adam steps the losses
#: within 5e-3 and each leaf's change within 0.02 of the larger of its norm
#: and the median leaf's (read on 4 seeds: 9.7e-4, 6.1e-3)
TOLERANCE = {"fp32": {"loss": 1e-6, "grad": 2e-5, "routed": 2e-5, "change": 2e-3},
             "bf16": {"loss": 5e-3, "grad": 0.2, "routed": 0.4, "change": 0.02}}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _grads(m, precision, ids, targets):
    """(the program's loss and gradients by leaf path, the reference's)."""
    cfg = _port(m, DTYPES[precision])
    params = _params(m, DTYPES[precision])
    loss = M.loss_fn(params, (ids, targets), cfg, M.correction_bias(cfg))
    grads = torch.autograd.grad(loss, [weights.get_path(params, p) for p in weights.paths(m)])
    ref_params = _params(m, torch.float32)
    ref_loss = KIND.loss(ref_params, ids, targets, m, None)
    ref_grads = torch.autograd.grad(ref_loss, [weights.get_path(ref_params, p)
                                               for p in weights.paths(m)])
    return (float(loss.detach()), dict(zip(weights.paths(m), grads)),
            float(ref_loss.detach()), dict(zip(weights.paths(m), ref_grads)))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_loss_and_every_gradient_match_the_reference(precision):
    m = _model()
    tol = TOLERANCE[precision]
    ids, targets = _batch(m)[0]
    loss, grads, ref_loss, ref_grads = _grads(m, precision, ids, targets)
    assert abs(loss - ref_loss) <= tol["loss"] * abs(ref_loss)
    assert len(grads) == len(weights.paths(m))
    for path, g in grads.items():
        limit = tol["routed" if path[-1] in ROUTED else "grad"]
        assert g.shape == ref_grads[path].shape
        assert _rel(g, ref_grads[path]) <= limit, (path, _rel(g, ref_grads[path]))


def test_an_fp32_adam_step_and_the_next_loss_match_the_reference():
    """The program's fused Adam step (flash) in fp32 against Adam written
    out on the reference's gradients (float32 moments, bias-corrected, the
    configuration's b1, b2 and eps): each leaf's change, and the next
    batch's loss at both sides' new parameters."""
    m = _model()
    tol = TOLERANCE["fp32"]
    (ids, targets), (ids2, targets2) = _batch(m)
    init_opt, step = M.make_train_step(_port(m, torch.float32), lr=OPT["lr"])
    params = _params(m, torch.float32)
    start = {p: weights.get_path(params, p).detach().clone() for p in weights.paths(m)}
    opt = init_opt(params)
    step(params, opt, (ids, targets))
    change = {p: weights.get_path(params, p).detach() - start[p] for p in start}
    next_loss = float(step(params, opt, (ids2, targets2))[2])
    _l, _g, _rl, ref_grads = _grads(m, "fp32", ids, targets)
    ref = _params(m, torch.float32)
    b1, b2 = OPT["b1"], OPT["b2"]
    with torch.no_grad():
        for path, g in ref_grads.items():
            mu, nu = (1 - b1) * g / (1 - b1), (1 - b2) * g * g / (1 - b2)
            ref_change = -OPT["lr"] * mu / (nu.sqrt() + OPT["eps"])
            assert _rel(change[path], ref_change) <= tol["change"], path
            weights.get_path(ref, path).add_(ref_change)
    ref_next = float(KIND.loss(ref, ids2, targets2, m, None).detach())
    assert abs(next_loss - ref_next) <= tol["loss"] * abs(ref_next)


def test_two_bf16_adam_steps_match_the_reference():
    """Two of the program's bf16 steps (flash) against the reference's own
    two steps from the same seed (``reference.follow``: float32, its Adam
    rounding each parameter to bf16): both losses, and each leaf's change
    as the benchmark's comparison measures it."""
    m = _model()
    tol = TOLERANCE["bf16"]
    batches = _batch(m)
    init_opt, step = M.make_train_step(_port(m, torch.bfloat16), lr=OPT["lr"])
    params = _params(m, torch.bfloat16)
    opt = init_opt(params)
    losses = [float(step(params, opt, batch)[2]) for batch in batches]
    ref = reference.follow(m, OPT, SEED, batches, 2, None, "cpu")
    for got, want in zip(losses, ref["loss"]):
        assert abs(got - want) <= tol["loss"] * abs(want)
    change = weights.change_norms(m, SEED, params, "cpu")
    gap = compare.numbers({"loss": losses, "grad1": ref["grad1"], "change": change}, ref)
    assert gap["change_gap"]["value"] <= tol["change"], gap["change_gap"]


def test_the_routing_is_the_references_assignment_for_assignment():
    """The route kernels' plain versions and the held index against the
    reference's route on the same float32 logits: each held expert's
    capacity buffer holds the reference's kept tokens in the same order,
    each with the reference's weight."""
    m = _model()
    o = m.own
    gen = torch.Generator().manual_seed(5)
    T, k, e = 512, o.topk, o.experts
    logits = torch.randn(T, e, generator=gen)
    bias = KIND.correction_bias(m)[0]
    topw, topi = K.moe_route(logits, k, bias, o.scale)
    cap = int(o.capacity_factor * T * k / e)
    idx = K.moe_index(topi.reshape(T * k), e, cap, k, o.held)
    expert, w, keep = KIND.routing(logits, m, bias)
    assert torch.equal(topi.reshape(T * k), expert)
    torch.testing.assert_close(topw.reshape(T * k), w, rtol=1e-6, atol=0)
    first, count = o.held
    for x in range(count):
        run = idx.order[idx.seg[x]:idx.seg[x + 1]][:cap]
        want = torch.nonzero((expert == first + x) & keep).squeeze(1)
        assert torch.equal(run, want)
    kept = (idx.inv - idx.seg[idx.flat_e]) < cap
    held = (expert >= first) & (expert < first + count)
    assert torch.equal(kept, keep & held)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal_len", [64, 192])
def test_flash_plain_versions_at_192_128_match_the_reference_attention(dtype, tol, causal_len):
    """The forward and both backward plain versions at q and k heads of 192
    and v heads of 128 (through ``FlashAttention``) against the reference's
    causal attention and its autograd in float32. fp32: summation order
    only; bf16: P and dS rounded to bf16 before their products, relative to
    the output's norm."""
    gen = torch.Generator().manual_seed(7)
    q, k = (torch.randn(2, causal_len, 2, 192, generator=gen) for _ in range(2))
    v, do = (torch.randn(2, causal_len, 2, 128, generator=gen) for _ in range(2))
    qk = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
    o = K.flash_attention(*qk)
    got = (o, *torch.autograd.grad(o, qk, do.to(dtype)))
    ref_in = [t.to(dtype).float().requires_grad_(True) for t in (q, k, v)]
    ref_o = reference.attention(*ref_in).reshape(o.shape)
    want = (ref_o, *torch.autograd.grad(ref_o, ref_in, do.to(dtype).float()))
    assert o.shape == (2, causal_len, 2, 128)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= tol, _rel(a, b)


@pytest.mark.parametrize("T,e,k", [(300, 64, 6), (64, 16, 6), (100, 8, 2), (7, 33, 3)])
def test_the_sigmoid_route_is_the_autograd_of_its_formula(T, e, k):
    """Forward and backward of the sigmoid route against autograd of the
    plain formula (DeepSeek-V3's MoEGate with one group), to float32
    rounding; the correction bias gets no gradient."""
    gen = torch.Generator().manual_seed(T + e)
    x = torch.randn(T, e, generator=gen, requires_grad=True)
    bias = (0.05 * torch.randn(e, generator=gen)).requires_grad_(True)
    g = torch.randn(T, k, generator=gen)
    topw, topi = K.moe_route(x, k, bias, 2.446)
    (topw * g).sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    s = torch.sigmoid(xr)
    ri = (s + bias.detach()).topk(k, -1).indices
    rv = s.gather(-1, ri)
    rw = rv / (rv.sum(-1, keepdim=True) + 1e-20) * 2.446
    (rw * g).sum().backward()
    assert torch.equal(topi, ri)
    torch.testing.assert_close(topw, rw, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-7)
    assert bias.grad is None


@pytest.mark.parametrize("held", [(0, 4), (4, 4), (12, 4), (5, 3), (0, 16)])
def test_the_held_index_is_a_filter_of_the_full_one(held):
    """Dispatch and combine, forward and backward, through the index of
    held experts equal the full index's restricted to those experts: their
    rows of the capacity buffer, and the combine with the other experts'
    weights at 0."""
    first, count = held
    gen = torch.Generator().manual_seed(11)
    T, k, e, h = 200, 6, 16, 8
    keys = torch.stack([torch.randperm(e, generator=gen)[:k] for _ in range(T)]).reshape(-1)
    cap = int(1.5 * T * k / e)
    part = K.moe_index(keys, e, cap, k, held)
    full = K.moe_index(keys, e, cap, k)
    assert part.seg.numel() == count + 1
    here = ((keys >= first) & (keys < first + count)).float()
    y, w = torch.randn(T, h, generator=gen), torch.rand(T * k, generator=gen)
    y, y_full = (y.clone().requires_grad_(True) for _ in range(2))
    w, w_full = (w.clone().requires_grad_(True) for _ in range(2))
    xin = K.moe_permute(y, None, part)
    xin_full = K.moe_permute(y_full, None, full)
    assert torch.equal(xin, xin_full[first:first + count])
    down = torch.randn(e, cap, h, generator=gen)
    out = K.moe_combine(down[first:first + count].contiguous(), w, part)
    out_full = K.moe_combine(down, w_full * here, full)
    torch.testing.assert_close(out, out_full, rtol=0, atol=0)
    g = torch.randn(T, h, generator=gen)
    (out * g).sum().backward()
    (out_full * g).sum().backward()
    torch.testing.assert_close(w.grad, w_full.grad * here, rtol=0, atol=0)
    xin.sum().backward()
    xin_full[first:first + count].sum().backward()
    torch.testing.assert_close(y.grad, y_full.grad, rtol=0, atol=0)


def test_the_shares_of_the_experts_add_up_to_the_uncut_layer():
    """An expert layer split over 4 chips of 4 experts each (experts 0-3,
    4-7, 8-11, 12-15), each share the program's routed part in fp32 with
    its experts' weights; their sum plus the shared experts, counted once,
    equals the uncut reference's layer (all 16 experts held), the same
    routes dropped at the uncut capacity."""
    whole = _model(n_routed_experts=16, experts_held=[0, 16])
    params = _params(whole, torch.float32)
    p = params["layers"][1]
    gen = torch.Generator().manual_seed(13)
    y = torch.randn(2, 64, whole.hidden, generator=gen)
    bias = KIND.correction_bias(whole)[0]
    total = M._shared(y, p)
    for first in range(0, 16, 4):
        share = _model(n_routed_experts=4, experts_held=[first, 4])
        cfg = _port(share, torch.float32)
        held = dict(p, experts_up=p["experts_up"][first:first + 4],
                    experts_down=p["experts_down"][first:first + 4])
        total = total + M._routed(y, held, cfg, bias)
    shared = reference.linear(reference.swiglu(reference.linear(y, p["shared_up"], None)),
                              p["shared_down"], None)
    want = shared + KIND.routed(y, p, whole, None, None, bias)
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)
    # a share holds an eighth of the uncut layer's assignments on average
    cfg = _port(whole, torch.float32)
    assert M._capacity(cfg, 128) == M._capacity(dataclasses.replace(cfg, experts_held=(0, 4)),
                                                128)


def test_the_config_refuses_math_attention():
    """Latent attention has one path, the flash kernels (their plain
    versions on the CPU): a config that asks for math attention is
    refused, and the default is flash."""
    assert M.MlaMoeConfig().use_flash_attn
    with pytest.raises(ValueError, match="flash kernels only"):
        M.MlaMoeConfig(use_flash_attn=False)


def test_the_kind_refuses_a_math_attention_cell():
    """The harness passes a cell's ``attention`` through
    ``program.port_config``: a Moonlight cell that asks for math attention
    fails at build, before any weight is made."""
    from portbench import program

    cell = {"linear": "bf16", "attention": "math"}
    with pytest.raises(ValueError, match="flash kernels only"):
        program.build(_model(), cell, OPT)
    init_opt, step = program.build(_model(), dict(cell, attention="flash"), OPT)
    assert callable(init_opt) and callable(step)
