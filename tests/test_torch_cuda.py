"""The CUDA kernels against their plain PyTorch versions, and the
manual-parallel step, the MoE reference and the int8 path on the card
against the CPU. Every test here needs a CUDA card and skips without
one; the file imports no jax, so it also runs on a machine with only
PyTorch:
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance, element by element: |kernel - plain| <= rtol * (|plain| +
rms(plain)), rtol 2^-7 for bf16 outputs (the two may round one bf16 ulp
apart; the plain versions round P and dS to bf16 where the wgmma kernels
do); for fp32 outputs 1e-4 for the flash kernels (summation order
only) and 1e-5 for SwiGLU (the sigmoids may differ in the last bits).
The int8 quantize kernels, the batched scenario replay and the search's
pipeline-schedule fold are held bit for bit (the replay also against the
scalar engine, the fold's scores against the numpy fold). So are the int8
dequantization, RoPE and the rms norm, forward and backward (the plain
norm sums in the kernels' order), and one small dense step on the card
and the CPU takes the same loss within 1e-3. So are the MoE dispatch and
combine kernels, forward and backward, at the CPU tests' cases and at the
MoE row's shape, on the card and against the CPU. So are the step-mode
SwiGLU kernels against the eager ops (``F.silu(gate) * val`` and its
autograd) and the rms norm with the residual, and one step of the dense
and MoE models on the card equals, loss and every updated parameter, the
same step run with the eager ops those kernels replace.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch.torchref import kernels as K  # noqa: E402


def _within(got, ref, rtol):
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= rtol * (ref.abs() + ref.square().mean().sqrt())).all())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernels_match_plain_versions(card, dtype, rtol, causal):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v, do = (torch.randn(2, 256, 2, 128, generator=gen, device=card).to(dtype)
                   for _ in range(4))
    K.reset_launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal)
    delta = K.flash_delta(o_ref, do)
    got = [o, K.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
           *K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)]
    ref = [o_ref, K.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal),
           *K.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)]
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "flash_fwd": 1,
                                 "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for (g, r), tol in zip([(lse, lse_ref)] + list(zip(got, ref)), [1e-4] + [rtol] * 4):
        g, r = g.float(), r.float()
        limit = tol * (r.abs() + r.square().mean().sqrt())
        assert bool(((g - r).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal", [
    (1, 1024, 1024, 2, 64, True),   # d = 64, 16 kv tiles
    (2, 320, 320, 3, 128, True),    # s = 64 mod 128
    (1, 512, 512, 2, 128, False),   # several kv tiles, non-causal
    (1, 320, 320, 2, 64, False),
    (1, 128, 320, 2, 64, True),     # more keys than queries: kv tiles past every query
    (2, 320, 128, 2, 128, True),    # more queries than keys
])
def test_bf16_wgmma_kernels_match_plain_versions(card, b, sq, skv, h, d, causal):
    gen = torch.Generator(device=card).manual_seed(1)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device=card).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=gen, device=card).bfloat16() for _ in range(2))
    K.reset_launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal)
    delta = K.flash_delta(o_ref, do)
    dq = K.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dq_ref = K.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    dk_ref, dv_ref = K.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 1
    assert _within(lse, lse_ref, 1e-4)
    for got, ref in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _within(got, ref, 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal", [
    (1, 1024, 1024, 2, 64, True),    # split: 8 chunks of 128 keys, most above the diagonal
    (2, 320, 320, 3, 128, True),     # split into a ragged last chunk
    (1, 512, 512, 2, 128, False),    # split, non-causal
    (4, 2048, 2048, 16, 64, True),   # one CTA a q tile
    (1, 128, 320, 2, 64, True),      # more keys than queries
    (2, 320, 128, 2, 128, True),     # more queries than keys
])
def test_fp32_forward_matches_its_plain_versions(card, b, sq, skv, h, d, causal):
    """The fp32 forward (split over kv chunks and merged where
    ``flash_fwd_kv_chunk`` says) against the whole-row plain version and
    the plain version of the same split, 1e-4 * (|plain| + rms(plain)),
    in one counted launch."""
    gen = torch.Generator(device=card).manual_seed(3)
    q = torch.randn(b, sq, h, d, generator=gen, device=card)
    k, v = (torch.randn(b, skv, h, d, generator=gen, device=card) for _ in range(2))
    K.reset_launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal)
    assert K.launch_counts()["flash_fwd"] == 1
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    chunk = K.flash_fwd_kv_chunk(b * h, sq, skv, sms) or None
    for ref_o, ref_lse in (K.flash_fwd_plain(q, k, v, causal),
                           K.flash_fwd_plain(q, k, v, causal, chunk)):
        assert _within(o, ref_o, 1e-4) and _within(lse, ref_lse, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal", [
    (1, 1024, 1024, 2, 64, True),    # both split into chunks of 128, many past the diagonal
    (2, 320, 320, 3, 128, True),     # split into a ragged last chunk
    (1, 512, 512, 2, 128, False),    # split, non-causal
    (1, 512, 512, 2, 64, False),
    (4, 2048, 2048, 16, 64, True),   # one CTA an output tile
    (2, 2048, 2048, 8, 128, False),
    (1, 128, 320, 2, 64, True),      # more keys than queries: kv tiles past every query
    (1, 192, 1024, 1, 64, True),     # ... with dk/dv split: chunks before every start block
    (2, 320, 128, 2, 128, True),     # more queries than keys
])
def test_fp32_backward_matches_its_plain_versions(card, b, sq, skv, h, d, causal):
    """The fp32 dq and dk/dv (split over their streamed tiles and summed
    where ``flash_bwd_chunks`` says) against the whole-row plain versions
    and the plain versions of the same split, 1e-4 * (|plain| +
    rms(plain)), in one counted launch of each wrapper."""
    gen = torch.Generator(device=card).manual_seed(4)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device=card) for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=gen, device=card) for _ in range(2))
    o, lse = K.flash_fwd_plain(q, k, v, causal)
    delta = K.flash_delta(o, do)
    K.reset_launch_counts()
    dq = K.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 1
    assert sum(counts.values()) == 2
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    kv_chunk, q_chunk = K.flash_bwd_chunks(b * h, sq, skv, sms)
    for kv_c, q_c in ((None, None), (kv_chunk or None, q_chunk or None)):
        dq_ref = K.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, kv_c)
        dk_ref, dv_ref = K.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, q_c)
        for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
            assert got.dtype == torch.float32 and got.shape == ref.shape
            assert _within(got, ref, 1e-4)


@pytest.mark.cuda
def test_bf16_kernels_take_a_tensor_that_is_not_16_byte_aligned(card):
    # one head: the [b*h, s, d] operand is a view of the input, which here
    # starts 2 bytes into its storage; the wrapper copies it to an aligned one
    gen = torch.Generator(device=card).manual_seed(2)
    base = torch.randn(1 * 128 * 1 * 64 + 1, generator=gen, device=card).bfloat16()
    q = base[1:].view(1, 128, 1, 64)
    o, lse = K.flash_fwd(q, q, q)
    o_ref, lse_ref = K.flash_fwd_plain(q, q, q)
    assert _within(o, o_ref, 2 ** -7) and _within(lse, lse_ref, 1e-4)


@pytest.mark.cuda
def test_explicit_flash_on_the_card_raises_for_a_shape_the_kernels_refuse(card):
    ragged = torch.zeros(1, 96, 2, 64, device=card)
    with pytest.raises(ValueError, match="do not take"):
        K.attention(ragged, ragged, ragged, use_flash=True)
    gqa_kv = torch.zeros(1, 128, 1, 64, device=card)
    q = torch.zeros(1, 128, 2, 64, device=card)
    with pytest.raises(ValueError, match="do not take"):
        K.attention(q, gqa_kv, gqa_kv, use_flash=True)
    # left to the dispatcher, such shapes take the math path
    assert K.attention(ragged, ragged, ragged).shape == ragged.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("shape", [(2, 64, 1024), (21, 200), (3, 24)])  # f = 512, 100, 12
def test_swiglu_kernels_match_plain_versions(card, dtype, rtol, shape):
    gen = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn(shape, generator=gen, device=card) * 3).to(dtype)
    dy = torch.randn((*shape[:-1], shape[-1] // 2), generator=gen, device=card).to(dtype)
    K.reset_launch_counts()
    out, dx = K.swiglu_fwd(x), K.swiglu_bwd(x, dy)
    torch.cuda.synchronize()
    assert K.launch_counts()["swiglu_fwd"] == 1 and K.launch_counts()["swiglu_bwd"] == 1
    assert out.dtype == dtype and dx.shape == x.shape
    assert _within(out, K.swiglu_fwd_plain(x), rtol)
    assert _within(dx, K.swiglu_bwd_plain(x, dy), rtol)
    # an unaligned base pointer takes the scalar loads of the same kernel
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=card)[1:].view(shape).copy_(x)
    assert _within(K.swiglu_fwd(xs), K.swiglu_fwd_plain(x), rtol)


@pytest.mark.cuda
def test_swiglu_on_the_card_raises_for_what_the_kernels_refuse(card):
    x = torch.zeros(8, 64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        K.swiglu(x[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        K.swiglu_bwd(x, torch.zeros(32, 8, device=card).t())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.swiglu(x.half())
    with pytest.raises(ValueError, match="even last dim"):
        K.swiglu(torch.zeros(8, 63, device=card))


@pytest.mark.cuda
def test_parallel_step_on_the_card_matches_the_cpu(card):
    from simumax_tpu_torch.torchref import parallel as T

    cfg = T.PPConfig(vocab_size=512, hidden_size=128, head_num=2, head_size=64,
                     intermediate_size=256, moe_ffn=128, expert_num=4, dtype=torch.float32)
    ids = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        with T.process_group(device):
            mesh = T.make_pp_mesh(1, pp=1, tp=1, ep=1, device=device)
            params, specs = T.init_pp_params(cfg, mesh, torch.Generator().manual_seed(0))
            K.reset_launch_counts()
            new, loss = T.make_pp_train_step(cfg, mesh, lr=1.0)(specs)(params, ids, ids)
            runs[device] = (float(loss), {k: v.cpu() for k, v in new.items()},
                            K.launch_counts())
    (loss_gpu, new_gpu, counts), (loss_cpu, new_cpu, _) = runs["cuda"], runs["cpu"]
    # the weightless norms of L = 2 layers: each layer's first norm
    # forward (and the final one) without the residual, its second with
    # the mid-block add; backward every layer norm with its output's
    # second gradient, the final one without
    L = cfg.layers_per_stage
    assert counts == {**dict.fromkeys(K.LAUNCHES, 0), "flash_fwd": 2, "flash_bwd_dq": 2,
                      "flash_bwd_dkv": 2, "swiglu_fwd": 2, "swiglu_bwd": 2,
                      "moe_route_fwd": 1, "moe_route_bwd": 1,
                      "rms_norm_weightless_fwd": L + 1, "rms_norm_weightless_residual_fwd": L,
                      "rms_norm_weightless_residual_bwd": 2 * L, "rms_norm_weightless_bwd": 1}
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for name in new_cpu:
        assert _within(new_gpu[name], new_cpu[name], 1e-4), name



def _tree_to(tree, device):
    """A params tree's leaves copied to ``device`` as new leaves."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.detach().to(device).requires_grad_(True)


@pytest.mark.cuda
def test_moe_reference_step_on_the_card_matches_the_cpu(card):
    """One fp32 Adam step of the MoE reference on the card against the
    same step on the CPU, with tokens dropped at capacity factor 1: the
    loss to rel 1e-5, every updated parameter to 1e-4 (|cpu| + rms(cpu))
    element by element (fp32 sums in other orders). The first Adam step
    moves an element by about lr times the sign of its gradient, so
    where the CPU's first moment is below 1e-3 of its leaf's largest (a
    gradient that rounding could flip) the two may step apart by 2 lr."""
    from simumax_tpu_torch.torchref import moe_model as M

    cfg = M.MoeConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4, head_size=64,
                      layer_num=2, expert_num=4, topk=2, moe_ffn=512, capacity_factor=1.0,
                      dtype=torch.float32)
    params = M.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, 512, (2, 64), generator=torch.Generator().manual_seed(0))
    lr, results = 1e-2, {}
    for device in ("cuda", "cpu"):
        init_opt, step = M.make_train_step(cfg, lr=lr)
        p = _tree_to(params, device)
        new, opt, loss = step(p, init_opt(p), (ids.to(device), ids.to(device)))
        results[device] = (float(loss), [x.detach().cpu() for x in M.param_leaves(new)],
                           [x.cpu() for x in M.param_leaves(opt["mu"])])
    (loss_gpu, new_gpu, _), (loss_cpu, new_cpu, mu_cpu) = results["cuda"], results["cpu"]
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for got, ref, mu in zip(new_gpu, new_cpu, mu_cpu):
        limit = 1e-4 * (ref.abs() + ref.square().mean().sqrt())
        limit = limit.where(mu.abs() >= 1e-3 * mu.abs().max(), limit.new_tensor(2 * lr))
        assert bool(((got - ref).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_on_the_card_matches_the_cpu(card, dtype):
    """The int8 products (NN forward, NT dgrad, TN wgrad) are integer
    arithmetic: equal on the card and the CPU. So are the quantized
    operands and the bf16 output and gradients of ``int8_matmul``, which
    round the same fp32 values."""
    from simumax_tpu_torch.torchref import quantized as Q

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 64, generator=gen).to(dtype)
    w = (torch.randn(64, 48, generator=gen) * 0.1).to(dtype)
    g = torch.randn(2, 40, 48, generator=gen).bfloat16()
    q = {(name, cols): Q._q8(t.reshape(-1, t.shape[-1]), column_major=cols)[0]
         for name, t in (("x", x), ("w", w), ("g", g)) for cols in (False, True)}
    # each operand in the order the int8 path quantizes it into
    for a, b, ta, tb, (ca, cb) in (("x", "w", False, False, (False, True)),
                                   ("g", "w", False, True, (False, False)),
                                   ("x", "g", True, False, (True, True))):
        ref = Q._mm(q[a, ca], q[b, cb], ta=ta, tb=tb)
        got = Q._mm(q[a, ca].to(card), q[b, cb].to(card), ta=ta, tb=tb)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), ref)
    outs = {}
    for device in ("cuda", "cpu"):
        xd, wd = (t.to(device).requires_grad_(True) for t in (x, w))
        y = Q.int8_matmul(xd, wd)
        outs[device] = [t.cpu() for t in (y, *torch.autograd.grad(y, (xd, wd), g.to(device)))]
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.cuda
def test_int_mm_shape_rules_raise_on_the_card(card):
    """The int8 path refuses, before the card does, the shapes
    ``torch._int_mm`` refuses there (it pads nothing), and takes 17 rows."""
    from simumax_tpu_torch.torchref import quantized as Q

    def ones(*shape):
        return torch.ones(shape, dtype=torch.int8, device=card)

    assert torch.equal(Q._mm(ones(17, 8), ones(8, 8).t()).cpu(), torch.full((17, 8), 8))
    for a, b in ((ones(16, 8), ones(8, 8)), (ones(32, 12), ones(12, 8)),
                 (ones(32, 8), ones(8, 12))):
        with pytest.raises(ValueError, match="more than 16 rows"):
            Q._mm(a, b)
        with pytest.raises(RuntimeError, match="greater than"):
            torch._int_mm(a, b)
    with pytest.raises(RuntimeError, match="dimension 2"):
        torch._int_mm(ones(2, 32, 8), ones(8, 8))


#: the int8 cell's linear layers (Aquila2-7B, 8192 tokens a step): (k, n)
#: of qkv, out, up (gate and up), down and the LM head
INT8_CELL_LINEAR = {"qkv": (4096, 12288), "out": (4096, 4096), "up": (4096, 22016),
                    "down": (11008, 4096), "head": (4096, 100008)}
#: the cell's 15 product shapes (m, k, n): each layer's forward x @ w,
#: dgrad g @ w^T and wgrad x^T @ g
INT8_CELL_PRODUCTS = {f"{name}-{layout}": shape for name, (k, n) in INT8_CELL_LINEAR.items()
                      for layout, shape in (("forward", (8192, k, n)), ("dgrad", (8192, n, k)),
                                            ("wgrad", (k, 8192, n)))}
#: (m, k, n, row stride or None): tails of m, n and k, rows of 1, 24 and
#: 8200, strides 8 mod 16 (the odd rows by 8-byte copies) and padded rows
INT8_EDGE_PRODUCTS = [(24, 48, 40, None), (24, 16, 8, None), (8200, 4112, 264, None),
                      (8200, 160, 100, 176), (8200, 136, 100, None), (17, 8, 8, None),
                      (33, 24, 12, None), (25, 40, 36, None), (130, 1000, 260, None),
                      (64, 48, 40, 56), (24, 100008, 72, None), (1, 16, 4, None),
                      (1, 24, 8, None)]


def _int8_operands(card, m, k, n, seed, ld=None, fill=None):
    """a [m, k] row-major and b [k, n] column-major (rows ``ld`` bytes
    apart where given), random int8 in [-127, 127] or ``fill``'s values."""
    ld = ld or k
    if fill is None:
        gen = torch.Generator(device=card).manual_seed(seed)
        a, bt = (torch.randint(-127, 128, (rows, ld), generator=gen, device=card,
                               dtype=torch.int8) for rows in (m, n))
    else:
        a, bt = (torch.full((rows, ld), v, device=card, dtype=torch.int8)
                 for rows, v in ((m, fill[0]), (n, fill[1])))
    return a[:, :k], bt[:, :k].t()


def _int8_reference(a, b):
    """The exact product: ``torch._int_mm`` where it takes the shape, else
    the plain version (float64) on the card."""
    (m, k), n = a.shape, b.shape[1]
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return K.int8_gemm_plain(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(INT8_CELL_PRODUCTS))
def test_int8_gemm_is_int_mm_at_the_int8_cells_products(card, case):
    """Bit for bit ``torch._int_mm``, in one launch, at each of the int8
    cell's product shapes (the LM head's dgrad through the 8-byte copies:
    its rows are 100008 bytes long)."""
    m, k, n = INT8_CELL_PRODUCTS[case]
    a, b = _int8_operands(card, m, k, n, seed=m + k + n)
    K.reset_launch_counts()
    got = K.int8_gemm(a, b)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "int8_gemm": 1}
    assert got.dtype == torch.int32 and torch.equal(got, torch._int_mm(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,ld", INT8_EDGE_PRODUCTS)
def test_int8_gemm_is_exact_at_the_edges(card, m, k, n, ld):
    a, b = _int8_operands(card, m, k, n, seed=m * n + k, ld=ld)
    assert torch.equal(K.int8_gemm(a, b), _int8_reference(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [133120, 100008])  # TMA's loads; the 8-byte copies
@pytest.mark.parametrize("fill", [(127, 127), (127, -127)])
def test_int8_gemm_holds_the_largest_sums(card, k, fill):
    """Every operand at +-127: each sum is +-127^2 k, at k 133120 within
    391,168 of int32's limit."""
    a, b = _int8_operands(card, 256, k, 64, seed=0, fill=fill)
    want = torch.full((256, 64), fill[0] * fill[1] * k, dtype=torch.int32, device=card)
    got = K.int8_gemm(a, b)
    assert torch.equal(got, want) and torch.equal(got, torch._int_mm(a, b))


@pytest.mark.cuda
def test_int8_gemm_refuses_what_its_loads_do_not_take(card):
    a, b = _int8_operands(card, 32, 12, 8, seed=0)
    with pytest.raises(ValueError, match="row strides"):
        K.int8_gemm(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("vocab", [1024, 1064])  # 1064: 8 mod 16, as Aquila2's 100008
def test_one_int8_step_on_the_card_runs_every_product_on_the_int8_gemm(card, vocab):
    from simumax_tpu_torch.torchref import model as M

    cfg = M.LlamaConfig(vocab_size=vocab, hidden_size=256, head_num=4, kv_head_num=2,
                        head_size=64, intermediate_size=512, layer_num=2, use_int8=True)
    params = M.init_params(cfg, seed=0, device=card)
    init_opt, step = M.make_train_step(cfg)
    opt = init_opt(params)
    ids = torch.randint(0, vocab, (1, 256), generator=torch.Generator().manual_seed(0)).to(card)
    K.reset_launch_counts()
    step(params, opt, (ids, ids))
    torch.cuda.synchronize()
    assert K.launch_counts()["int8_gemm"] == 3 * (4 * cfg.layer_num + 1)


def _events_s(calls, fn, samples=1):
    """Seconds per call of ``samples`` back-to-back windows of ``calls``
    eager calls of ``fn`` between CUDA events, queued behind the graph
    timer's spin kernel; a list, one per window."""
    from simumax_tpu_torch.calibration import timing

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(samples + 1)]
    torch.cuda._sleep(timing.LEAD_CYCLES)
    marks[0].record()
    for mark in marks[1:]:
        for _ in range(calls):
            fn()
        mark.record()
    marks[-1].synchronize()
    return [x.elapsed_time(y) * 1e-3 / calls for x, y in zip(marks, marks[1:])]


@pytest.mark.cuda
def test_graph_timer_agrees_with_event_timing_on_a_long_gemm(card):
    """On a GEMM of over a millisecond the graph timer agrees within 2%
    with CUDA events around back-to-back eager calls, in three
    alternating turns. The eager window repeats the graph timer's: queued
    behind the same spin kernel (the host may take as long to issue a
    call as the card to run it, and must not show), as many samples of
    as many calls. The GEMM is fp32 on the CUDA cores (TF32 off): a bf16
    tensor-core GEMM of this length runs at the clock the card's power
    cap allows, which changes from one turn to the next (the test below
    holds the bf16 GEMM under one load)."""
    from simumax_tpu_torch.calibration import timing

    gen = torch.Generator(device=card).manual_seed(0)
    a, b = (torch.randn(4096, 4096, generator=gen, device=card) for _ in range(2))
    turns = []
    with torch.no_grad():
        _events_s(timing.PILOT_CALLS, lambda: a @ b)
        for _ in range(3):
            g = timing.time_graph(lambda: a @ b)
            calls = math.ceil(timing.MIN_SAMPLE_S / g)
            turns.append((g, timing.robust_median(
                _events_s(calls, lambda: a @ b, timing.GRAPH_ITERS))))
    print("fp32 4096^3: graph / eager ms " + ", ".join(
        f"{g * 1e3:.4f} / {e * 1e3:.4f}" for g, e in turns))
    assert min(g for g, _ in turns) >= 1e-3
    assert abs(sorted(g / e for g, e in turns)[1] - 1) <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,size", [(torch.float32, 4096), (torch.bfloat16, 8192)])
def test_graph_replays_and_eager_calls_agree_under_one_load(card, dtype, size):
    """A replay of a graph of n GEMMs and a window of n eager GEMMs take
    the same time when they alternate inside one unbroken load, within
    2% (medians of five each), after 0.3 s of GEMMs have settled the
    clock under the power cap. n is what :func:`time_graph` sizes a
    sample to. This holds the timer apart from the clock: at bf16 8192³
    separate turns of the graph timer and of an eager window of the same
    length read up to 13% apart, either way round, as the clock the cap
    allows moves between turns."""
    from simumax_tpu_torch.calibration import timing

    gen = torch.Generator(device=card).manual_seed(0)
    a, b = (torch.randn(size, size, generator=gen, device=card).to(dtype) for _ in range(2))
    with torch.no_grad():
        per_call = timing.time_graph(lambda: a @ b)
        calls = math.ceil(timing.MIN_SAMPLE_S / per_call)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            a @ b
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                a @ b
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
        for _ in range(math.ceil(0.3 / per_call)):
            a @ b
        marks[0].record()
        for i in range(5):
            graph.replay()
            marks[2 * i + 1].record()
            for _ in range(calls):
                a @ b
            marks[2 * i + 2].record()
        marks[-1].synchronize()
    spans = [x.elapsed_time(y) * 1e-3 / calls for x, y in zip(marks, marks[1:])]
    replayed, eager = timing.robust_median(spans[0::2]), timing.robust_median(spans[1::2])
    print(f"{dtype} {size}^3 under one load, {calls} calls a sample: graph "
          f"{replayed * 1e3:.4f} ms, eager {eager * 1e3:.4f} ms; time_graph "
          f"{per_call * 1e3:.4f} ms")
    assert per_call >= 1e-3
    assert abs(replayed / eager - 1) <= 0.02


@pytest.mark.cuda
def test_graph_timer_counts_each_replayed_launch(card):
    """The warm-up calls count as launched, the captures count nothing,
    and each replay counts every launch it captured: 2 + 4 (the pilot
    graph's replay) + n x 5 (five samples)."""
    from simumax_tpu_torch.calibration import timing

    q, k, v = (torch.randn(1, 256, 2, 64, device=card).bfloat16() for _ in range(3))
    K.reset_launch_counts()
    with torch.no_grad():
        timing.time_graph(lambda: K.flash_fwd(q, k, v, True))
    counts = K.launch_counts()
    assert counts["flash_fwd"] > 6 and (counts["flash_fwd"] - 6) % 5 == 0
    assert sum(counts.values()) == counts["flash_fwd"]


@pytest.mark.cuda
def test_graph_timer_holds_no_memory_once_it_returns(card):
    """Timing again allocates nothing that outlives the timing: the
    captured graphs and their pools are freed, and every warm-up and
    capture runs on one side stream, so cuBLAS pins no new workspace."""
    from simumax_tpu_torch.calibration import timing

    a, b = (torch.randn(1024, 1024, device=card).bfloat16() for _ in range(2))
    with torch.no_grad():
        timing.time_graph(lambda: a @ b)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        for _ in range(4):
            timing.time_graph(lambda: a @ b)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_an_oom_inside_a_capture_ends_it_and_is_retried(card):
    from simumax_tpu_torch.calibration import autocal, timing

    x = torch.ones(1024, device=card)
    state = {"raised": False}

    def op():
        if torch.cuda.is_current_stream_capturing() and not state["raised"]:
            state["raised"] = True
            raise torch.cuda.OutOfMemoryError("injected inside the capture")
        return x * 2

    attempts = []

    def measure():
        attempts.append(torch.cuda.is_current_stream_capturing())
        return timing.time_graph(op)

    assert autocal.with_retries(measure, backoff=0.0) > 0
    assert attempts == [False, False] and state["raised"]
    assert not torch.cuda.is_current_stream_capturing()


@pytest.mark.cuda
def test_sdp_bwd_key_reads_the_same_with_the_host_slowed(card):
    """The flash row's ``sdp_bwd`` key, timed from CUDA graphs, reads
    within 5% of itself while a thread spinning in Python holds the
    interpreter lock."""
    from simumax_tpu_torch import bench
    from simumax_tpu_torch.calibration import autocal
    from simumax_tpu_torch.calibration.timing import host_slowed

    perf = bench.predict_step(bench.build_bench_model(), "h100_sxm", "flash")
    key = next(iter(perf.system.miss_efficiency["sdp_bwd"]))
    plain = autocal.calibrate_key("sdp_bwd", key, perf.system)
    with host_slowed():
        slowed = autocal.calibrate_key("sdp_bwd", key, perf.system)
    assert 0 < plain <= 1 and abs(slowed - plain) <= 0.05 * plain


@pytest.mark.cuda
def test_moe_step_syncs_the_host_nowhere(card):
    """A MoE training step (tokens dropped, top-2 and top-4) runs under
    ``set_sync_debug_mode("error")``: its dispatch has static shapes."""
    from simumax_tpu_torch.torchref import moe_model as M

    for e, k in ((4, 2), (8, 4)):
        cfg = M.MoeConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4,
                          head_size=64, layer_num=2, expert_num=e, topk=k, moe_ffn=512,
                          capacity_factor=0.5)
        params = M.init_params(cfg, seed=0, device=card)
        ids = torch.randint(0, 512, (2, 64), generator=torch.Generator().manual_seed(0)).to(card)
        init_opt, step = M.make_train_step(cfg)
        opt = init_opt(params)
        params, opt, _ = step(params, opt, (ids, ids))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, opt, loss = step(params, opt, (ids, ids))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(loss)


@pytest.mark.cuda
def test_top4_moe_combine_on_the_card_repeats_bit_for_bit_and_matches_the_cpu(card):
    """The top-4 MoE layer (tokens dropped): two bf16 runs on the card give
    equal outputs and gradients, bit for bit; in fp32 the card's model
    gives the CPU's logits within 1e-5 of their largest (the CPU test's
    tolerance against JAX)."""
    from simumax_tpu_torch.torchref import moe_model as M

    sizes = dict(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4, head_size=64,
                 layer_num=2, expert_num=8, topk=4, moe_ffn=512, capacity_factor=0.5)
    y0 = torch.randn(1, 64, 256, generator=torch.Generator().manual_seed(2))
    runs = []
    for _ in range(2):
        cfg = M.MoeConfig(dtype=torch.bfloat16, **sizes)
        p = M.init_params(cfg, seed=3, device=card)["layers"][0]
        y = y0.to(card, torch.bfloat16).requires_grad_(True)
        out = M._moe_mlp(y, p, cfg)
        runs.append([out, *torch.autograd.grad(out.float().square().sum(),
                                               [y, p["gate"], p["moe_up"], p["moe_down"]])])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    cfg = M.MoeConfig(dtype=torch.float32, **sizes)
    params = M.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, 512, (1, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = M.forward(params, ids, cfg)
        got = M.forward(_tree_to(params, card), ids.to(card), cfg).cpu()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _q8_inputs(rows, cols, dtype, card):
    """x [rows, cols] with exact .5 ties of x / scale among its values
    (x = (j + 0.5) * scale where the fp32 product divides back exactly)."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = (torch.randn(rows, cols, generator=gen, device=card) * 3).to(dtype)
    amax = x.float().abs().max()
    scale = (amax + 1e-6) / torch.full_like(amax, 127.0)
    ties = ((torch.arange(-20, 20, device=card, dtype=torch.float32) + 0.5) * scale).to(dtype)
    r = ties.float() / scale
    ties = ties[r - r.floor() == 0.5][: x.numel()]
    x.view(-1)[: ties.numel()] = ties
    return x


def _q8_launches(kernels):
    """The launch counts a list of quantize kernels adds."""
    counts = dict.fromkeys(K.LAUNCHES, 0)
    for kernel in kernels:
        counts[K.Q8_KERNELS[kernel][1]] += 1
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cols", [
    (2048, 2048), (2048, 5504), (2048, 4096), (2048, 11008), (5504, 2048), (2048, 32000),
    (21, 100), (64, 8), (130, 70), (1, 9), (17, 32), (16, 16), (48, 16), (80, 272),
    # cols 8 mod 16 (Aquila2's LM head among them), rows not a multiple of 16
    (2048, 100008), (2048, 2056), (64, 136), (100, 264), (37, 136), (131, 1000), (3, 257),
])
def test_q8_kernels_are_bit_identical_to_their_plain_versions(card, dtype, rows, cols):
    """amax and every quantize order (row-major, column-major, both from
    one read) equal their plain versions bit for bit (true IEEE division,
    round half to even), at the int8 row's shapes, at aligned shapes with
    partial tiles, and at ragged and misaligned ones; each wrapper
    launches the kernels :func:`q8_route` names, once each."""
    x = _q8_inputs(rows, cols, dtype, card)
    # the same values at offsets that are not 16-byte aligned (and, for
    # fp32, one that is)
    views = [x]
    for offset in (1, 4):
        buf = torch.empty(rows * cols + offset, dtype=dtype, device=card)
        views.append(buf[offset:].view(rows, cols))
        views[-1].copy_(x)
    for t in views:
        amax_ref = K.q8_amax_plain(t)
        K.reset_launch_counts()
        amax = K.q8_amax(t)
        assert K.launch_counts() == {**_q8_launches([]), "q8_amax": 1}
        assert amax.dtype == torch.float32 and torch.equal(amax, amax_ref)
        q_ref, scale_ref = K.q8_quantize_plain(t, amax_ref)
        for column_major, both in ((False, False), (True, False), (False, True)):
            K.reset_launch_counts()
            out = K.q8_quantize(t, amax, column_major=column_major, both=both)
            route = K.q8_route(rows, cols, dtype, t.data_ptr(), column_major, both)
            assert K.launch_counts() == _q8_launches(route), route
            qs, scale = (out[:2], out[2]) if both else ((out[0],), out[1])
            orders = (False, True) if both else (column_major,)
            for c, q in zip(orders, qs):
                assert q.dtype == torch.int8 and q.shape == (rows, cols)
                assert q.stride() == ((1, rows) if c else (cols, 1)) or rows == 1 or cols == 1
                assert torch.equal(q, q_ref), (route, c, int((q != q_ref).sum()))
            assert torch.equal(scale, scale_ref)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("both", [False, True])
def test_q8_tma_kernels_replay_from_a_cuda_graph(card, both):
    """The TMA quantize kernels allocate and synchronise nothing: a
    capture of amax and quantize replays on new values of the same input
    buffer, bit for bit as the plain versions."""
    x = _q8_inputs(256, 384, torch.bfloat16, card)
    assert K.q8_route(256, 384, x.dtype, x.data_ptr(), True, both)[0].endswith("_tma_kernel")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K.q8_quantize(x, K.q8_amax(x), column_major=True, both=both)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.q8_quantize(x, K.q8_amax(x), column_major=True, both=both)
    for seed in (1, 2):
        gen = torch.Generator(device=card).manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=gen, device=card) * seed)
        graph.replay()
        torch.cuda.synchronize()
        ref = K.q8_quantize_plain(x, K.q8_amax_plain(x), column_major=True, both=both)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("both", [False, True])
@pytest.mark.parametrize("rows,cols,offset", [(256, 392, 0), (100, 264, 1)])
def test_q8_ragged_kernel_replays_from_a_cuda_graph(card, both, rows, cols, offset):
    """The ragged quantize kernel, column-major and both orders, at a
    shape TMA refuses (cols 8 mod 16) and at a base 1 element off,
    allocates and synchronises nothing: a capture of amax and quantize
    replays on new values of the same input buffer, bit for bit as the
    plain versions."""
    buf = torch.empty(rows * cols + offset, dtype=torch.bfloat16, device=card)
    x = buf[offset:].view(rows, cols)
    x.copy_(_q8_inputs(rows, cols, torch.bfloat16, card))
    assert K.q8_route(rows, cols, x.dtype, x.data_ptr(), True, both) == (
        "q8_quantize_ragged_kernel",)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K.q8_quantize(x, K.q8_amax(x), column_major=True, both=both)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    K.reset_launch_counts()
    with torch.cuda.graph(graph):
        out = K.q8_quantize(x, K.q8_amax(x), column_major=True, both=both)
    assert K.launch_counts()["q8_quantize_ragged"] == 1
    for seed in (1, 2):
        gen = torch.Generator(device=card).manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=gen, device=card) * seed)
        graph.replay()
        torch.cuda.synchronize()
        ref = K.q8_quantize_plain(x, K.q8_amax_plain(x), column_major=True, both=both)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.cuda
def test_q8_wrappers_raise_for_what_the_kernels_refuse(card):
    x = torch.ones(8, 16, device=card)
    amax = K.q8_amax(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.q8_amax(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        K.q8_amax(x.t())
    with pytest.raises(ValueError, match="2-D"):
        K.q8_quantize(x.view(-1), amax)
    with pytest.raises(ValueError, match="float32 scalar"):
        K.q8_quantize(x, amax.view(1))


def _smoke():
    """``chip_smoke.py`` as a module (its functions import torch lazily)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row_step_case(kind):
    from simumax_tpu_torch.torchref import rows

    mc = rows.build_model(kind)
    return mc, dict(kind=kind, seq_len=256, batch_size=1, layers=2, remat=kind == "remat")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "remat", "flash", "int8", "moe"])
def test_captured_row_step_takes_the_eager_steps(card, kind):
    """A row's step (2 layers, seq 256) replayed from a CUDA graph gives,
    step by step, the losses of the same steps run eagerly from the same
    seed: equal bit for bit (the captured launches are the eager ones,
    on the same cuBLAS algorithms). Each replay counts the CUDA kernels
    it runs; the capture counts none."""
    from simumax_tpu_torch.calibration.timing import time_captured_step, time_stateful
    from simumax_tpu_torch.torchref import rows

    mc, case = _row_step_case(kind)
    model_kind = "dense" if kind == "remat" else kind
    step = rows.make_row_step(model_kind, mc, case["seq_len"], case["batch_size"],
                              case["layers"], case["remat"], device=card)
    eager = []
    time_stateful(lambda: eager.append(step().clone()), warmup=2, iters=3)
    del step
    step = rows.make_row_step(model_kind, mc, case["seq_len"], case["batch_size"],
                              case["layers"], case["remat"], device=card)
    K.reset_launch_counts()
    seconds, losses = time_captured_step(step, warmup=2, iters=3)
    counts = K.launch_counts()
    assert seconds > 0 and losses.shape == (5,)
    assert torch.equal(losses, torch.stack(eager)), (losses.tolist(), eager)
    per_step = {"flash": {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2},
                # 4 linear layers a layer and the LM head, 5 quantizes
                # each: x row-major and w column-major forward, g in both
                # orders from one read, w row-major and x column-major
                # backward
                "int8": {"q8_amax": 5 * 9, "q8_quantize": 2 * 9, "q8_quantize_cols_tma": 2 * 9,
                         "q8_quantize_both_tma": 9}}.get(kind, {})
    # the norms (with and without the residual), RoPE, SwiGLU, the int8
    # dequantizations, the MoE dispatch and combine and Adam, as
    # chip_smoke.py counts them a step
    per_step.update(_smoke().fused_per_step(model_kind, case["layers"], case["remat"]))
    assert counts == {k: 5 * per_step.get(k, 0) for k in counts}


@pytest.mark.cuda
def test_a_step_that_reads_the_host_fails_to_capture_and_is_not_timed(card):
    from simumax_tpu_torch.calibration.timing import time_captured_step

    x = torch.ones(4, device=card)
    with pytest.raises(RuntimeError):
        time_captured_step(lambda: x.mul_(float(x.sum())), warmup=1, iters=2)


# -- the batched scenario replay ------------------------------------------------


def _replay_groups(cell_key, card_backend=True):
    """A cell's estimate, and every family group the batched replay
    solved in a lockstep walk of seeded scenarios on the card:
    [(family, program, [(sub-scenario, fault model)], raw makespans)]."""
    from simumax_tpu_torch import PerfLLM
    from simumax_tpu_torch.core.config import get_model_config, get_strategy_config
    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import CELLS, SYNC_CELL, build_perf, mixed, sampled

    cell = SYNC_CELL if cell_key == "dense-pp2-sync" else CELLS[cell_key]
    perf = build_perf(PerfLLM, get_model_config, get_strategy_config, **cell)
    h = perf.simulate(None, world_ranks=True, granularity="chunk",
                      track_memory=False)["end_time_ms"]
    groups = []
    ctx = tf.ReplayContext(perf, options=tf.ReplayOptions(replay_backend="cuda"))
    orig = ctx._solve_groups

    def solve_groups(grp, outs):
        for fam, prog, members in grp.values():
            models = [m for _it, m in members]
            before = K.launch_counts()["replay_solve"]
            raws = br.solve_batch(prog, models)
            assert K.launch_counts()["replay_solve"] == before + 1
            groups.append((fam, prog, [(it[1], m) for it, m in members], raws))
        return orig(grp, outs)

    ctx._solve_groups = solve_groups
    scs = sampled(tf.sample_scenario, cell_key, perf.strategy.world_size, h, n=4) + [
        mixed(tf.FaultEvent, tf.FaultScenario, h, death=False)]
    tf._predict_goodput_batch(ctx, [(s, tf.CheckpointSpec(interval_steps=2)) for s in scs])
    return ctx, groups


@pytest.mark.cuda
@pytest.mark.parametrize("cell_key", ["dense-pp2", "moe-pp4", "mla-pp2", "dense-pp2-sync"])
def test_replay_kernel_is_bit_identical_to_its_plain_version(card, cell_key):
    """Every family group a walk of seeded scenarios hands the kernel,
    and every lowered family with all its scenarios in one batch: the
    kernel's makespans == the plain version's == the scalar engine's."""
    from simumax_tpu_torch.simulator import batched_replay as br

    ctx, groups = _replay_groups(cell_key)
    assert groups
    by_prog = {}
    for fam, prog, members, raws in groups:
        plain = br.replay_solve_plain(br.pack_batch(prog, [m for _s, m in members], "cpu"))
        assert raws.tolist() == plain.tolist(), (cell_key, prog.n_ops)
        for (sub, _m), raw in zip(members, raws):
            assert raw == ctx._replay(sub, fam)[2]
        by_prog.setdefault(id(prog), (prog, []))[1].extend(m for _s, m in members)
    for prog, models in by_prog.values():
        got = K.replay_solve(br.pack_batch(prog, models, card)).cpu()
        want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu"))
        assert got.tolist() == want.tolist(), (cell_key, prog.n_ops, len(models))


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", [1, 15000])  # the value slots in shared memory / in scratch
def test_replay_kernel_takes_every_op_kind_and_fault(card, repeat):
    """A family with every lowered op kind (async chains, send_sync,
    wait_comm, both advances) under overlapping slowdowns, preemptions
    and scoped and unscoped link windows, in one batch: the kernel ==
    the plain version. At 15000 repeats the op table (30k ops) holds
    more value slots than a block's shared memory."""
    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import synthetic_family, synthetic_models

    streams, plan = synthetic_family(repeat)
    prog = br.lower_family(streams, plan)
    models = synthetic_models(tf, plan)
    if repeat > 1:  # keep the plain version's loop short: no slowdown on class 0
        models = [m for m in models if 0 not in m._slow]
    assert (prog.n_ops + 1) * 8 > K._REPLAY_SMEM_MAX or repeat == 1
    K.reset_launch_counts()
    got = K.replay_solve(br.pack_batch(prog, models, card)).cpu()
    assert K.launch_counts()["replay_solve"] == 1
    want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu"))
    assert got.tolist() == want.tolist()
    if repeat == 1:  # the faults move the makespan (the long chain absorbs them)
        assert len(set(want.tolist())) > 2


@pytest.mark.cuda
def test_replay_kernel_takes_a_level_wider_than_its_block(card):
    """1100 classes: 1100 independent compute ops, a collective over all
    of them (a warp's masked max over 35 mask words), 1100 more. A level
    holds more ops than the block's 1024 threads; the kernel, through
    the family's memoised tables and its packed scenarios, == the plain
    version == the scalar engine."""
    import types

    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from simumax_tpu_torch.simulator.engine import ReplayProc, SimuEngine
    from torch_fault_cells import synthetic_models

    k = 1100
    streams = [[("compute", 1.0 + c / 1024, "a", "c"),
                ("collective", "x:tp", 0.5, "ar", list(range(k))),
                ("compute", 0.25 * (c % 3), "b", "c")] for c in range(k)]
    plan = types.SimpleNamespace(n_classes=k, reps=tuple(range(k)))
    prog = br.lower_family(streams, plan)
    models = synthetic_models(tf, plan)
    tables = br.replay_tables(prog, card)
    assert tables.max_width == k and tables.threads == 1024 and tables.n_steps == 3
    K.reset_launch_counts()
    got = br.solve_batch(prog, models)
    assert K.launch_counts()["replay_solve"] == 1
    want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu")).tolist()
    assert got.tolist() == want
    for m, raw in zip(models, want):
        eng = SimuEngine(k, drop_events=True)
        for i in range(k):
            eng.add_rank(i, ReplayProc(streams[i]))
        eng._fault = m
        eng.run_incremental()
        assert raw == max(eng.clock)


@pytest.mark.cuda
def test_replay_kernel_takes_a_batch_of_264(card):
    """The largest family a walk of the MoE cell lowers, under 264
    scenarios (the walk's, repeated): two blocks on every SM of the card,
    every makespan == the plain version's."""
    from simumax_tpu_torch.simulator import batched_replay as br

    _ctx, groups = _replay_groups("moe-pp4")
    by_prog = {}
    for _fam, prog, members, _raws in groups:
        by_prog.setdefault(id(prog), (prog, []))[1].extend(m for _s, m in members)
    prog, models = max(by_prog.values(), key=lambda pm: (pm[0].n_ops, len(pm[1])))
    models = [models[j % len(models)] for j in range(264)]
    got = br.solve_batch(prog, models)
    want = br.replay_solve_plain(br.pack_batch(prog, models, "cpu"))
    assert len(got) == 264 and got.tolist() == want.tolist()


@pytest.mark.cuda
def test_analyze_faults_on_the_card_equals_the_scalar_engine_with_two_jobs(card):
    """``replay_backend="cuda"`` equals ``"numpy"``; with CUDA initialised
    the two-worker pool spawns its workers and gives the serial result."""
    import json

    from simumax_tpu_torch import PerfLLM
    from simumax_tpu_torch.core.config import get_model_config, get_strategy_config
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import CELLS, build_perf

    perf = build_perf(PerfLLM, get_model_config, get_strategy_config, **CELLS["dense-pp2"])
    kw = dict(n_scenarios=4, seed=2, horizon_steps=6, spec=tf.CheckpointSpec(interval_steps=3))
    K.reset_launch_counts()
    on_card = perf.analyze_faults(options=tf.ReplayOptions(replay_backend="cuda"), **kw)
    assert K.launch_counts()["replay_solve"] > 0 and torch.cuda.is_initialized()
    assert tf._mc_context().get_start_method() == "spawn"
    two = perf.analyze_faults(jobs=2, options=tf.ReplayOptions(replay_backend="cuda"), **kw)
    scalar = perf.analyze_faults(options=tf.ReplayOptions(replay_backend="numpy"), **kw)
    dump = [json.dumps(x, sort_keys=True) for x in (on_card, two, scalar)]
    assert dump[0] == dump[1] == dump[2]


@pytest.mark.cuda
def test_replay_wrapper_raises_for_what_the_kernel_refuses(card):
    from simumax_tpu_torch.simulator import batched_replay as br
    from simumax_tpu_torch.simulator import faults as tf
    from torch_fault_cells import synthetic_family, synthetic_models

    streams, plan = synthetic_family()
    prog = br.lower_family(streams, plan)
    rb = br.pack_batch(prog, synthetic_models(tf, plan), card)
    with pytest.raises(ValueError, match="must be contiguous"):
        K.replay_solve(dataclasses_replace(rb, dur=rb.dur.float()))
    with pytest.raises(ValueError, match="is on cpu"):
        K.replay_solve(dataclasses_replace(rb, kind=rb.kind.cpu()))


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


# -- the search's pipeline-schedule folds ------------------------------------------


def _fold_inputs(pp, vp, mbc, group, n, seed, device):
    import numpy as np

    from simumax_tpu_torch.search import batched as tb

    gen = np.random.default_rng(seed)
    fwd, bwd = gen.uniform(0.01, 5.0, (2, pp, vp, n))
    p2p = gen.uniform(0.0, 2.0, n)
    blocking = np.where(gen.random(n) < 0.5, 0.0, p2p)
    ops = torch.from_numpy(tb.fold_levels(tb.fold_table(pp, vp, mbc, group))[0]).to(device)
    return (ops, *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in (fwd, bwd, p2p, blocking)))


FOLD_SHAPES = [(2, 1, 1, 0), (3, 1, 17, 0), (4, 1, 8, 0), (8, 1, 64, 0), (2, 2, 4, 2),
               (3, 3, 12, 6), (4, 2, 16, 4), (4, 4, 64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("pp,vp,mbc,group", FOLD_SHAPES)
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_fold_kernel_is_bit_identical_to_its_plain_version(card, pp, vp, mbc, group, n):
    """Both schedules (vp 1 is 1F1B), a batch of 1 and ragged batches:
    the kernel's ends and totals equal the plain version's on the card
    and on the CPU bit for bit, in one launch under the schedule's key."""
    args = _fold_inputs(pp, vp, mbc, group, n, pp * 100 + n, card)
    K.reset_launch_counts()
    got = K.fold_schedule(*args)
    counts = K.launch_counts()
    key = "fold_1f1b" if vp == 1 else "fold_interleaved"
    assert counts[key] == 1 and sum(counts.values()) == 1
    assert torch.equal(got, K.fold_schedule_plain(*args))
    assert torch.equal(got.cpu(), K.fold_schedule(*(a.cpu() for a in args)))


@pytest.mark.cuda
@pytest.mark.parametrize("pp,vp,mbc,n", [(2, 1, 2048, 3), (4, 1, 2048, 5), (2, 1, 8192, 2)])
def test_fold_kernel_walks_tables_that_do_not_fit_in_shared_memory(card, pp, vp, mbc, n):
    """8192 ops: one candidate a block, table and state in shared memory;
    16384: the state in shared memory, the table read from global memory;
    32768: both in global memory. Bit for bit the plain version."""
    args = _fold_inputs(pp, vp, mbc, 0, n, mbc + n, card)
    layout = K.fold_layout(args[0].shape[0], pp, vp)
    assert layout[1:3] == {8192: (True, True), 16384: (False, True),
                           32768: (False, False)}[args[0].shape[0]]
    assert torch.equal(K.fold_schedule(*args), K.fold_schedule_plain(*args))


@pytest.mark.cuda
def test_fold_kernel_refuses_a_table_out_of_level_order(card):
    """The flat table (no level offsets) gives NaN ends and totals on the
    card; its plain version raises."""
    from simumax_tpu_torch.search import batched as tb

    ops, *rest = _fold_inputs(4, 1, 8, 0, 7, 5, card)
    flat = torch.from_numpy(tb.fold_table(4, 1, 8, 0)).to(card)
    out = K.fold_schedule(flat, *rest)
    assert out.shape == (5, 7) and bool(out.isnan().all())
    assert not bool(K.fold_schedule(ops, *rest).isnan().any())
    with pytest.raises(K.KernelError, match="level-ordered"):
        K.fold_schedule_plain(flat, *rest)


@pytest.mark.cuda
@pytest.mark.parametrize("spec,margin", [
    (dict(pp_size=2, pp_comm_async=False), 13.0),  # the larger splits take no fold
    (dict(pp_size=2, tp_size=2, enable_recompute=True, recompute_granularity="full_block",
          recompute_layer_num=1), None),
    (dict(pp_size=2, interleaving_size=2), None)])
def test_scorer_on_the_card_equals_the_numpy_fold(card, spec, margin):
    """``BatchedScorer(backend="cuda")`` on the card against
    ``backend="numpy"``, bit for bit, with candidates the cost margin
    leaves unfolded (``inf``) between those the kernel folds."""
    import numpy as np

    from simumax_tpu_torch.core.config import (get_model_config, get_strategy_config,
                                               get_system_config)
    from simumax_tpu_torch.search import batched as tb

    vpp = "interleaving_size" in spec
    st = get_strategy_config("tp1_pp1_dp8_mbs1")
    st.world_size = 16 if vpp else 8
    for k, v in spec.items():
        setattr(st, k, v)
    st.__post_init__()
    model = get_model_config("llama3-8b" if vpp else "llama2-tiny")
    system = get_system_config("tpu_v5p_256" if vpp else "tpu_v5e_256")
    if vpp:
        mbc = list(range(st.vpp_group_size, 65, st.vpp_group_size))
        mbs, nrc = [1] * len(mbc), None
    else:
        splits = [(1, 8), (2, 4), (4, 2), (8, 1)]
        mbs, mbc = [splits[i % 4][0] for i in range(64)], [splits[i % 4][1] for i in range(64)]
        nrc = [i % 3 for i in range(64)]
    scores = {}
    for backend in ("cuda", "numpy"):
        kern = tb.BatchedScorer(model, system, backend=backend).kernel_for(st)
        K.reset_launch_counts()
        scores[backend] = kern.score(mbs, mbc, nrc=nrc, cost_margin=margin, backend=backend)
        launched = K.launch_counts()["fold_interleaved" if vpp else "fold_1f1b"]
        assert (launched > 0) == (backend == "cuda")
    for key in ("iter_time", "mfu", "tgs", "max_peak_bytes", "fits_margin_bytes"):
        assert np.array_equal(scores["cuda"][key], scores["numpy"][key]), key
    if margin is not None:
        finite = np.isfinite(scores["cuda"]["iter_time"])
        assert finite.any() and not finite.all()


def _mixtral_guided_sweep(**kw):
    from simumax_tpu_torch.core.config import (get_model_config, get_strategy_config,
                                               get_system_config)
    from simumax_tpu_torch.search import search_best_parallel_strategy

    base = get_strategy_config("ep4_pp2_dp4_mbs1")
    base.world_size = 64
    base.__post_init__()
    return search_best_parallel_strategy(
        base, get_model_config("mixtral-8x7b"), get_system_config("tpu_v5p_256"), 64, topk=5,
        tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4, 8), ep_list=(1, 2, 4, 8),
        zero_list=(0, 1, 2, 3), engine="batched", search_mode="guided", **kw)


class _RefusingFoldLibrary:
    """A fold library whose every launch is refused (cudaErrorInvalidValue)."""

    def fold_schedule(self, *args):
        return 1


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["launch", "build"])
def test_a_guided_sweep_whose_kernel_fails_raises(card, monkeypatch, tmp_path, how):
    """The guided Mixtral sweep launches the fold kernel under the
    defaults; a refused launch, or a fold source that does not compile,
    must stop it with a KernelError instead of returning rows."""
    from simumax_tpu_torch.search import executor as te

    monkeypatch.setattr(te, "_SCORERS", {})
    if how == "launch":
        monkeypatch.setitem(K._libs, "fold", _RefusingFoldLibrary())
    else:
        broken = tmp_path / "fold_broken.cu"
        broken.write_text('extern "C" int fold_schedule( { return 0; }\n')
        monkeypatch.delitem(K._libs, "fold", raising=False)
        monkeypatch.setitem(K._SOURCES, "fold", str(broken))
    with pytest.raises(K.KernelError):
        _mixtral_guided_sweep()


@pytest.mark.cuda
def test_guided_sweep_on_the_card_with_two_jobs_equals_the_serial_sweep(card):
    """With CUDA initialised the sweep's pool spawns its workers; the
    rows equal the serial sweep's as JSON, and the fold kernel ran."""
    import json

    from simumax_tpu_torch.search import executor as te

    K.reset_launch_counts()
    serial = _mixtral_guided_sweep()
    assert K.launch_counts()["fold_1f1b"] > 0 and torch.cuda.is_initialized()
    assert te._mp_context().get_start_method() == "spawn"
    pooled = _mixtral_guided_sweep(jobs=2)
    assert json.dumps(pooled, sort_keys=True) == json.dumps(serial, sort_keys=True)


@pytest.mark.cuda
def test_sharded_step_on_one_card_is_the_single_device_step(card):
    """On a 1 x 1 mesh (NCCL, one rank) the DTensor step with SP and FSDP
    takes the losses and parameters bit for bit of the single-device step,
    both on the norm, RoPE, SwiGLU and (``use_int8``) int8 kernels, and
    runs no collective; its sharded step launches those kernels and no
    plain version."""
    from simumax_tpu_torch.calibration.validate import CollectiveRecord
    from simumax_tpu_torch.torchref import model as M
    from simumax_tpu_torch.torchref import parallel as P

    ids = torch.randint(0, 1024, (1, 256), generator=torch.Generator().manual_seed(0))
    for int8 in (False, True):
        cfg = M.LlamaConfig(vocab_size=1024, hidden_size=256, head_num=4, kv_head_num=2,
                            head_size=64, intermediate_size=512, layer_num=2, use_int8=int8)
        params0 = M.init_params(cfg, seed=0, device=card)
        one = M._map_tree(lambda t: t.detach().clone().requires_grad_(True), params0)
        init_opt, step = M.make_train_step(cfg)
        opt = init_opt(one)
        losses = [float(step(one, opt, (ids.to(card), ids.to(card)))[2]) for _ in range(2)]
        with P.process_group("cuda"):
            mesh = M.make_mesh(1, tp=1)
            params = M.place_params(params0, mesh, M.param_shardings(cfg, mesh, fsdp=True))
            init_opt, step = M.make_train_step(cfg, mesh=mesh, sp=True)
            opt, batch = init_opt(params), M.shard_batch((ids, ids), mesh)
            before = K.launch_counts()
            with CollectiveRecord(mesh) as record:
                got = [float(step(params, opt, batch)[2]) for _ in range(2)]
            launched = K.take_launches(before)
            whole = [p.full_tensor() for p in M.param_leaves(params)]
        assert got == losses and not record.entries
        assert all(torch.equal(a.detach(), b.detach())
                   for a, b in zip(M.param_leaves(one), whole))
        for key in ("rms_norm_fwd", "rms_norm_residual_fwd", "rms_norm_residual_bwd",
                    "rope_fwd", "rope_bwd", "swiglu_step_fwd", "swiglu_step_bwd"):
            assert launched[key] > 0, key
        assert (launched["q8_amax"] > 0 and launched["q8_dequant"] > 0) is int8


@pytest.mark.cuda
def test_memory_report_on_the_card(card):
    from simumax_tpu_torch.calibration.validate import memory_report
    from simumax_tpu_torch.torchref.rows import build_bench_model

    report = memory_report(build_bench_model(), 1, 512, 1)
    assert set(report) == {"argument_size_in_bytes", "output_size_in_bytes",
                           "temp_size_in_bytes", "peak_memory_in_bytes"}
    args, peak = report["argument_size_in_bytes"], report["peak_memory_in_bytes"]
    assert 0 < args < peak and report["temp_size_in_bytes"] == peak - args
    # the update is in place: the step leaves its arguments and the loss
    assert abs(report["output_size_in_bytes"] - args) <= 2 ** 20


@pytest.mark.cuda
def test_entry_and_the_one_rank_dry_run_on_the_card(card, capsys):
    from simumax_tpu_torch import entry as E
    from simumax_tpu_torch.torchref import model as M

    fn, (params, ids) = E.entry()
    with torch.no_grad():
        got = fn(params, ids).float().cpu()
        ref = fn(M._map_tree(lambda t: t.detach().cpu(), params), ids.cpu()).float()

    def ce(logits):
        return float(-torch.log_softmax(logits, -1).gather(-1, ids.cpu()[..., None]).mean())

    assert abs(ce(got) - ce(ref)) <= 2e-3 * abs(ce(ref))
    losses = E.dryrun_multichip(1)
    assert set(losses) == {"dp_tp", "manual"} and all(math.isfinite(v) for v in losses.values())
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


# -- the fused ops of the measured step: rms norm, RoPE, int8 dequantization ---

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,h", [(2048, 2048), (2048, 1024), (21, 100), (3, 20000), (5, 33),
                                    (1, 2048), (4097, 4096), (2048, 8192), (64, 32768),
                                    (7, 5001)])
def test_rms_norm_kernels_match_their_plain_versions(card, dtype, rows, h):
    gen = torch.Generator(device=card).manual_seed(5)
    x = (torch.randn(rows, h, generator=gen, device=card) * 2).to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=card)).to(dtype)
    dy = torch.randn(rows, h, generator=gen, device=card).to(dtype)
    K.reset_launch_counts()
    y, rstd = K.rms_norm_fwd(x, w)
    y_ref, rstd_ref = K.rms_norm_fwd_plain(x, w)
    dx, dw = K.rms_norm_bwd(x, w, rstd_ref, dy)
    dx_ref, dw_ref = K.rms_norm_bwd_plain(x, w, rstd_ref, dy)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "rms_norm_fwd": 1,
                                 "rms_norm_bwd": 1}
    assert y.dtype == dtype and dx.dtype == dtype and dw.dtype == dtype
    for got, ref in ((y, y_ref), (rstd, rstd_ref), (dx, dx_ref), (dw, dw_ref)):
        assert torch.equal(got, ref), int((got != ref).sum())
    # and on the CPU: the plain versions are the kernels' arithmetic
    cpu = [t.cpu() for t in (x, w, dy)]
    y_cpu, rstd_cpu = K.rms_norm_fwd_plain(*cpu[:2])
    assert torch.equal(y_cpu, y.cpu()) and torch.equal(rstd_cpu, rstd.cpu())
    assert all(torch.equal(a, b.cpu()) for a, b in
               zip(K.rms_norm_bwd_plain(cpu[0], cpu[1], rstd_cpu, cpu[2]), (dx, dw)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,n,kv,d", [(1, 2048, 16, 8, 128), (2, 64, 8, 8, 128),
                                        (2, 7, 3, 1, 20), (1, 5, 2, 2, 6)])
def test_rope_kernel_is_bit_identical_to_its_plain_versions(card, dtype, b, s, n, kv, d):
    """Forward and backward on the q and k views of a fused qkv tensor
    (strided, read in place) and on a contiguous copy."""
    gen = torch.Generator(device=card).manual_seed(6)
    qkv = torch.randn(b, s, (n + 2 * kv) * d, generator=gen, device=card).to(dtype)
    q = qkv[..., :n * d].reshape(b, s, n, d)
    k = qkv[..., n * d:(n + kv) * d].reshape(b, s, kv, d)
    for x in (q, k, k.contiguous()):
        K.reset_launch_counts()
        got, got_bwd = K.rope_fwd(x, 1e4), K.rope_bwd(x, 1e4)
        assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "rope_fwd": 1,
                                     "rope_bwd": 1}
        assert got.is_contiguous() and got.dtype == dtype
        assert torch.equal(got, K.rope_fwd_plain(x, 1e4))
        assert torch.equal(got_bwd, K.rope_bwd_plain(x, 1e4))


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cols", [(2048, 32000), (2048, 100008), (21, 100), (3, 5)])
def test_q8_dequant_kernel_is_bit_identical_to_its_plain_version(card, out, rows, cols):
    gen = torch.Generator(device=card).manual_seed(7)
    acc = torch.randint(-2 ** 24, 2 ** 24, (rows, cols), generator=gen, device=card,
                        dtype=torch.int32)
    sa = torch.tensor(0.0123, device=card)
    sb = torch.tensor(0.000456, device=card)
    off = torch.empty(rows * cols + 1, dtype=torch.int32, device=card)[1:].view(rows, cols)
    off.copy_(acc)
    for t in (acc, off):
        K.reset_launch_counts()
        got = K.q8_dequant(t, sa, sb, out)
        assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "q8_dequant": 1}
        assert got.dtype == out and torch.equal(got, K.q8_dequant_plain(t, sa, sb, out))


@pytest.mark.cuda
def test_fused_ops_raise_for_what_the_kernels_refuse(card):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.rms_norm_fwd(torch.zeros(4, 8, dtype=torch.float16, device=card),
                       torch.ones(8, dtype=torch.float16, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        K.rms_norm_fwd(torch.zeros(8, 4, device=card).t(), torch.ones(8, device=card))
    with pytest.raises(ValueError, match="last dim contiguous"):
        K.rope_fwd(torch.zeros(1, 4, 8, 2, device=card).transpose(2, 3), 1e4)
    with pytest.raises(ValueError, match="even d"):
        K.rope_fwd(torch.zeros(1, 4, 2, 7, device=card), 1e4)
    with pytest.raises(ValueError, match="contiguous"):
        K.q8_dequant(torch.zeros(8, 4, dtype=torch.int32, device=card).t(),
                     torch.tensor(1.0, device=card), torch.tensor(1.0, device=card),
                     torch.bfloat16)


@pytest.mark.cuda
def test_rope_tables_are_not_kept_from_a_capture(card):
    """A table made while a CUDA graph is captured lives in the graph's
    pool: it is used and not kept; one made eagerly is kept."""
    x = torch.randn(1, 24, 2, 64, generator=torch.Generator().manual_seed(8)).to(card)
    x = x.bfloat16()
    key = (x.device, 24, 64, 1e4, torch.bfloat16)
    K._ROPE_TABLES.pop(key, None)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.rope_fwd(x, 1e4)
    assert key not in K._ROPE_TABLES
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, K.rope_fwd_plain(x, 1e4))
    K.rope_fwd(x, 1e4)
    assert key in K._ROPE_TABLES


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_the_dense_step_launches_the_fused_kernels(card, remat):
    """One step of a small bf16 Llama: 2L + 1 norms forward and backward
    (each block's second norm forward with the residual add, each block
    norm's backward with its input's second gradient), and 2L RoPEs (q and
    k of each layer), forward and backward; the step-mode SwiGLU once a
    layer each way; recompute re-runs each block's norms, RoPEs and SwiGLU
    forward; one Adam launch for all the leaves; the loss within 1e-3 of
    the CPU's."""
    from simumax_tpu_torch.torchref import model as M

    cfg = M.LlamaConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=2,
                        head_size=64, intermediate_size=512, layer_num=3)
    params = M.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, 512, (1, 128), generator=torch.Generator().manual_seed(0))
    losses = {}
    for device in ("cpu", "cuda"):
        p = M._map_tree(lambda t: t.detach().to(device, copy=True).requires_grad_(True), params)
        init_opt, step = M.make_train_step(cfg, remat=remat)
        K.reset_launch_counts()
        losses[device] = float(step(p, init_opt(p), (ids.to(device), ids.to(device)))[2])
    L = cfg.layer_num
    again = 2 if remat else 1
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0),
                                 "rms_norm_fwd": L * again + 1,
                                 "rms_norm_residual_fwd": L * again,
                                 "rms_norm_bwd": 1, "rms_norm_residual_bwd": 2 * L,
                                 "swiglu_step_fwd": L * again, "swiglu_step_bwd": L,
                                 "rope_fwd": 2 * L * again, "rope_bwd": 2 * L,
                                 "adam_multi_tensor": 1}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,offset", [((2048, 11008), 0), ((8, 1024, 3584), 0),
                                          ((21, 200), 0), ((3, 7, 512), 0), ((33, 11008), 1)])
def test_swiglu_step_kernels_are_the_eager_ops_bit_for_bit(card, dtype, shape, offset):
    """The step mode against ``F.silu(gate) * val`` over ``up.chunk(2, -1)``
    and its autograd on the card, bit for bit, from an aligned base and
    one ``offset`` elements off (the scalar instances)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=card).manual_seed(10)
    n = math.prod(shape)
    up = torch.empty(n + offset, device=card, dtype=dtype)[offset:].view(shape)
    up.copy_(torch.randn(shape, generator=gen, device=card) * 3)
    dy = torch.randn(*shape[:-1], shape[-1] // 2, generator=gen, device=card).to(dtype)
    K.reset_launch_counts()
    out, d_up = K.swiglu_step_fwd(up), K.swiglu_step_bwd(up, dy)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "swiglu_step_fwd": 1,
                                 "swiglu_step_bwd": 1}
    a = up.detach().clone().requires_grad_(True)
    gate, val = a.chunk(2, dim=-1)
    eager = F.silu(gate) * val
    eager.backward(dy)
    assert torch.equal(out, eager.detach()) and torch.equal(d_up, a.grad)
    assert torch.equal(out, K.swiglu_step_fwd_plain(up))
    assert torch.equal(d_up, K.swiglu_step_bwd_plain(up, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,h", [(2048, 2048), (2048, 1024), (21, 100), (3, 20000),
                                    (4097, 4096), (64, 32768), (7, 5001)])
def test_rms_norm_residual_kernels_match_their_plain_versions(card, dtype, rows, h):
    gen = torch.Generator(device=card).manual_seed(11)
    x, a, dy, gs = ((torch.randn(rows, h, generator=gen, device=card) * sc).to(dtype)
                    for sc in (2, 2, 1, 1))
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=card)).to(dtype)
    K.reset_launch_counts()
    got_fwd = K.rms_norm_residual_fwd(x, w, a)
    ref_fwd = K.rms_norm_residual_fwd_plain(x, w, a)
    s, _y, rstd = ref_fwd
    got_bwd = K.rms_norm_residual_bwd(s, w, rstd, dy, gs)
    ref_bwd = K.rms_norm_residual_bwd_plain(s, w, rstd, dy, gs)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "rms_norm_residual_fwd": 1,
                                 "rms_norm_residual_bwd": 1}
    for got, ref in zip(got_fwd + got_bwd, ref_fwd + ref_bwd):
        assert got.dtype == ref.dtype and torch.equal(got, ref), int((got != ref).sum())
    assert got_bwd[0].data_ptr() != gs.data_ptr()
    # the Function against the eager composition (the add, the norm, the
    # engine's sum of the two gradients)
    xs, ws, as_ = (t.clone().requires_grad_(True) for t in (x, w, a))
    s_f, y_f = K.rms_norm_residual(xs, ws, as_)
    ((y_f.float() * dy.float()).sum() + (s_f.float() * gs.float()).sum()).backward()
    xe, we, ae = (t.clone().requires_grad_(True) for t in (x, w, a))
    s_e = xe + ae
    y_e = K.rms_norm(s_e, we)
    ((y_e.float() * dy.float()).sum() + (s_e.float() * gs.float()).sum()).backward()
    for got, ref in ((s_f, s_e), (y_f, y_e), (xs.grad, xe.grad), (ws.grad, we.grad),
                     (as_.grad, ae.grad)):
        assert torch.equal(got.detach(), ref.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True], ids=["norm", "residual"])
@pytest.mark.parametrize("rows,h", [(2048, 1024), (21, 1000), (37, 8192), (0, 1024)])
def test_weightless_rms_norm_kernels_match_plain_and_unit_weight(card, dtype, residual, rows, h):
    """The norm kernels without a weight (w None, the manual step's
    ``_rms``), with and without the residual: bit for bit their plain
    versions and the weighted kernels at a unit weight; one launch each
    way on the weightless keys (none at 0 rows), no dw. 21 and 37 rows are not a multiple of a
    backward block's rows (8 at h 1000 and 1024 in bf16; 2 at 8192); h
    1000 takes the scalar accesses."""
    gen = torch.Generator(device=card).manual_seed(14)
    x, a, dy, gs = ((torch.randn(rows, h, generator=gen, device=card) * sc).to(dtype)
                    for sc in (2, 2, 1, 1))
    ones = torch.ones(h, dtype=dtype, device=card)
    if residual:
        names = ("rms_norm_weightless_residual_fwd", "rms_norm_weightless_residual_bwd")
        K.reset_launch_counts()
        got_fwd = K.rms_norm_residual_fwd(x, None, a)
        s, _y, rstd = got_fwd
        got_bwd = K.rms_norm_residual_bwd(s, None, rstd, dy, gs)
        launched = K.launch_counts()
        ref_fwd = K.rms_norm_residual_fwd_plain(x, None, a)
        ref_bwd = K.rms_norm_residual_bwd_plain(s, None, rstd, dy, gs)
        unit_fwd = K.rms_norm_residual_fwd(x, ones, a)
        unit_bwd = K.rms_norm_residual_bwd(s, ones, rstd, dy, gs)
    else:
        names = ("rms_norm_weightless_fwd", "rms_norm_weightless_bwd")
        K.reset_launch_counts()
        got_fwd = K.rms_norm_fwd(x, None)
        rstd = got_fwd[1]
        got_bwd = K.rms_norm_bwd(x, None, rstd, dy)
        launched = K.launch_counts()
        ref_fwd = K.rms_norm_fwd_plain(x, None)
        ref_bwd = K.rms_norm_bwd_plain(x, None, rstd, dy)
        unit_fwd = K.rms_norm_fwd(x, ones)
        unit_bwd = K.rms_norm_bwd(x, ones, rstd, dy)
    torch.cuda.synchronize()
    assert launched == {**dict.fromkeys(K.LAUNCHES, 0), **dict.fromkeys(names, int(rows > 0))}
    assert got_bwd[1] is None and ref_bwd[1] is None
    for got, ref, unit in zip(got_fwd + got_bwd[:1], ref_fwd + ref_bwd[:1],
                              unit_fwd + unit_bwd[:1]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref), int((got != ref).sum())
        assert torch.equal(got, unit), int((got != unit).sum())


@pytest.mark.cuda
def test_weightless_norm_and_route_backward_replay_from_a_cuda_graph(card):
    """The weightless norm kernels (with and without the residual) and
    the route's backward captured in one CUDA graph: a replay on new
    inputs, written into the captured tensors, gives their plain
    versions' bits; no tensor is made during the capture beyond the
    outputs."""
    gen = torch.Generator(device=card).manual_seed(15)

    def norm_inputs():
        return [(torch.randn(300, 1024, generator=gen, device=card) * sc).to(torch.bfloat16)
                for sc in (2, 2, 1, 1)]

    def route_inputs():
        x = _route_logits(card, 2048, 8, torch.bfloat16, False, seed=int(
            torch.randint(0, 1000, (), generator=gen, device=card)))
        _topw, topi, probs = K.moe_route_fwd(x, 2)
        return [torch.randn(2048, 2, generator=gen, device=card).to(torch.bfloat16), probs, topi]

    x, a, dy, gs = norm_inputs()
    g, probs, topi = route_inputs()
    s, y, rstd = K.rms_norm_residual_fwd(x, None, a)  # warm each path before the capture
    K.rms_norm_residual_bwd(s, None, rstd, dy, gs)
    K.rms_norm_bwd(x, None, K.rms_norm_fwd(x, None)[1], dy)
    K.moe_route_bwd(g, probs, topi)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s, y, rstd = K.rms_norm_residual_fwd(x, None, a)
        d, _ = K.rms_norm_residual_bwd(s, None, rstd, dy, gs)
        y1, rstd1 = K.rms_norm_fwd(x, None)
        dx1, _ = K.rms_norm_bwd(x, None, rstd1, dy)
        d_logits = K.moe_route_bwd(g, probs, topi)
    for t, new in zip((x, a, dy, gs, g, probs, topi), norm_inputs() + route_inputs()):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    s_ref, y_ref, rstd_ref = K.rms_norm_residual_fwd_plain(x, None, a)
    d_ref, _ = K.rms_norm_residual_bwd_plain(s_ref, None, rstd_ref, dy, gs)
    y1_ref, rstd1_ref = K.rms_norm_fwd_plain(x, None)
    dx1_ref, _ = K.rms_norm_bwd_plain(x, None, rstd1_ref, dy)
    for got, ref in ((s, s_ref), (y, y_ref), (rstd, rstd_ref), (d, d_ref), (y1, y1_ref),
                     (rstd1, rstd1_ref), (dx1, dx1_ref),
                     (d_logits, K.moe_route_bwd_plain(g, probs, topi))):
        assert torch.equal(got, ref), int((got != ref).sum())


def _eager_ops(monkeypatch):
    """What the blocks ran before the SwiGLU and residual fusions: the
    residual add as its own op before the norm kernel, and ``F.silu(gate)
    * val`` over ``up.chunk(2, -1)``."""
    import torch.nn.functional as F

    from simumax_tpu_torch.torchref import model as M
    from simumax_tpu_torch.torchref import moe_model as MoE

    def norm_residual(x, w, add=None):
        s = x if add is None else x + add
        return s, M._norm(s, w)

    def swiglu(up):
        gate, val = up.chunk(2, dim=-1)
        return F.silu(gate) * val

    for mod in (M, MoE):
        monkeypatch.setattr(mod, "_norm_residual", norm_residual)
        monkeypatch.setattr(mod, "swiglu_step", swiglu)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,remat,int8", [
    ("dense", torch.bfloat16, False, False), ("dense", torch.float32, False, False),
    ("dense", torch.bfloat16, True, False), ("dense", torch.bfloat16, False, True),
    ("moe", torch.bfloat16, False, False)])
def test_the_steps_on_the_card_are_the_eager_ops_steps(card, kind, dtype, remat, int8,
                                                       monkeypatch):
    """Two steps of a small model on the card with the SwiGLU and residual
    kernels and with the eager ops they replace, from the same params:
    losses, parameters and moments bit for bit."""
    from simumax_tpu_torch.torchref import model as M
    from simumax_tpu_torch.torchref import moe_model as MoE

    if kind == "moe":
        cfg = MoE.MoeConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4,
                            head_size=64, layer_num=2, expert_num=4, topk=2, moe_ffn=512,
                            dtype=dtype)
        mod, kw = MoE, {}
    else:
        cfg = M.LlamaConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=2,
                            head_size=64, intermediate_size=512, layer_num=2, dtype=dtype,
                            use_int8=int8)
        mod, kw = M, {"remat": remat}
    params = mod.init_params(cfg, seed=0, device=card)
    ids = torch.randint(0, 512, (1, 128), generator=torch.Generator().manual_seed(0)).to(card)

    def run():
        p = M._map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
        init_opt, step = mod.make_train_step(cfg, **kw)
        opt = init_opt(p)
        losses = [float(step(p, opt, (ids, ids))[2]) for _ in range(2)]
        return losses, [M.param_leaves(t) for t in (p, opt["mu"], opt["nu"])]

    losses, leaves = run()
    with monkeypatch.context() as m:
        _eager_ops(m)
        losses_ref, leaves_ref = run()
    assert losses == losses_ref
    for got, ref in zip(leaves, leaves_ref):
        assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(got, ref))


# -- the MoE dispatch and combine -------------------------------------------------

MOE_KERNELS = ("moe_permute_fwd", "moe_permute_bwd", "moe_combine_fwd", "moe_combine_bwd")
ROUTE_KERNELS = ("moe_route_fwd", "moe_route_bwd", "moe_index")


def _moe_inputs(card, tokens, h, e, k, cf, dtype, seed=9):
    """Routing from random logits (each token's top-k experts) and the
    four kernels' inputs on the card: (y, w, index, dxin, dwbuf, down, g)."""
    from simumax_tpu_torch.torchref import moe_model as M

    gen = torch.Generator(device=card).manual_seed(seed)
    logits = torch.randn(tokens, e, generator=gen, device=card)
    flat_e = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    idx = M.moe_index(flat_e, e, int(cf * tokens * k / e), k)

    def rows(*shape):
        return torch.randn(*shape, generator=gen, device=card).to(dtype)

    w = torch.rand(tokens * k, generator=gen, device=card).to(dtype)
    return (rows(tokens, h), w, idx, rows(e, idx.cap, h), rows(e, idx.cap), rows(e, idx.cap, h),
            rows(tokens, h))


def _moe_calls(y, w, idx, dxin, dwbuf, down, g, probs, plain=False):
    """The four functions (kernels, or their plain versions) on one case:
    [xin, wbuf, dy, dw, out, d_down, dw of the combine]."""
    fns = [getattr(K, f"{name}_plain" if plain else name) for name in MOE_KERNELS]
    xin, wbuf = fns[0](y, w if probs else None, idx)
    dy, dw = fns[1](dxin, dwbuf if probs else None, idx)
    out = fns[2](down, None if probs else w, idx)
    d_down, dw_c = fns[3](g, down, None if probs else w, idx)
    return [xin, wbuf, dy, dw, out, d_down, dw_c]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("probs", [False, True], ids=["weighted-combine", "dispatch_probs"])
@pytest.mark.parametrize("tokens,h,e,k,cf", [
    (64, 256, 4, 2, 2.0), (64, 256, 4, 2, 0.5), (64, 256, 8, 4, 2.0), (64, 256, 8, 4, 0.5),
    (2048, 1024, 8, 2, 2.0),   # the MoE row
    (128, 256, 4, 2, 1.0),     # chip_smoke.py phase 4's fp32 step
    (300, 100, 8, 2, 2.0),     # h not a multiple of 8: scalar accesses
    (77, 40, 6, 3, 0.7),
])
def test_moe_dispatch_kernels_are_bit_identical_to_their_plain_versions(card, tokens, h, e, k,
                                                                       cf, probs, dtype):
    """Each of the four kernels, bit for bit against its plain version on
    the card and on the CPU, each launched once."""
    case = _moe_inputs(card, tokens, h, e, k, cf, dtype)
    K.reset_launch_counts()
    got = _moe_calls(*case, probs)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), **dict.fromkeys(MOE_KERNELS, 1)}
    ref = _moe_calls(*case, probs, plain=True)
    y, w, idx, *rest = case
    cpu_idx = K.MoeIndex(*(t.cpu() for t in idx[:4]), idx.cap, idx.k)
    cpu = _moe_calls(y.cpu(), w.cpu(), cpu_idx, *(t.cpu() for t in rest), probs, plain=True)
    for name, a, b, c in zip(("xin", "wbuf", "dy", "dw", "out", "d_down", "dw of the combine"),
                             got, ref, cpu):
        if b is None:
            assert a is None and c is None, name
            continue
        assert a.dtype == dtype and a.is_contiguous(), name
        assert torch.equal(a, b), (name, int((a != b).sum()))
        assert torch.equal(a.cpu(), c), (name, int((a.cpu() != c).sum()))


@pytest.mark.cuda
def test_moe_dispatch_kernels_raise_for_what_they_refuse(card):
    y, w, idx, dxin, dwbuf, down, g = _moe_inputs(card, 64, 256, 4, 2, 2.0, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.moe_permute_fwd(y.half(), None, idx)
    with pytest.raises(ValueError, match="contiguous"):
        K.moe_combine_fwd(down.transpose(1, 2).contiguous().transpose(1, 2), w, idx)
    with pytest.raises(ValueError, match="must be on"):
        K.moe_permute_fwd(y.cpu(), None, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("probs", [False, True], ids=["weighted-combine", "dispatch_probs"])
def test_the_moe_layer_runs_the_kernels_and_no_index_put(card, probs):
    """The MoE layer on the card (top-4, tokens dropped), forward and
    backward, launches each of the four dispatch kernels and the three
    route and index kernels once (and the step-mode SwiGLU once each
    way), runs no ``index_put``, sort, ``searchsorted``, top-k, softmax
    or scatter and no op that syncs the host, and its output and
    gradients repeat bit for bit; a whole model's loss and gradients
    launch each once a layer."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from simumax_tpu_torch.torchref import moe_model as M

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    cfg = M.MoeConfig(vocab_size=512, hidden_size=256, head_num=4, kv_head_num=4, head_size=64,
                      layer_num=3, expert_num=8, topk=4, moe_ffn=512, capacity_factor=0.5,
                      dispatch_probs=probs)
    y0 = torch.randn(2, 64, 256, generator=torch.Generator().manual_seed(2))
    runs = []
    for _ in range(2):
        p = M.init_params(cfg, seed=3, device=card)["layers"][0]
        y = y0.to(card, torch.bfloat16).requires_grad_(True)
        K.reset_launch_counts()
        with Record() as rec:
            out = M._moe_mlp(y, p, cfg)
            grads = torch.autograd.grad(out.float().square().sum(),
                                        [y, p["gate"], p["moe_up"], p["moe_down"]])
        assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0),
                                     **dict.fromkeys(MOE_KERNELS + ROUTE_KERNELS, 1),
                                     "swiglu_step_fwd": 1, "swiglu_step_bwd": 1}
        assert "bmm" in rec.ops
        assert not rec.ops & {"index_put", "index_put_", "nonzero", "masked_select",
                              "_local_scalar_dense", "item", "sort", "searchsorted", "scatter",
                              "scatter_", "topk", "_softmax", "softmax", "argmax"}
        runs.append([out, *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    params = M.init_params(cfg, seed=0, device=card)
    ids = torch.randint(0, 512, (2, 64), generator=torch.Generator().manual_seed(0)).to(card)
    K.reset_launch_counts()
    torch.autograd.grad(M.loss_fn(params, (ids, ids), cfg), M.param_leaves(params))
    assert {k: K.launch_counts()[k] for k in MOE_KERNELS + ROUTE_KERNELS} == dict.fromkeys(
        MOE_KERNELS + ROUTE_KERNELS, cfg.layer_num)


# -- the MoE route and index --------------------------------------------------------


def _route_logits(card, tokens, e, dtype, ties, seed=11):
    """Random logits on the card; with ``ties`` every odd column a copy of
    the even one before it and each row's largest value in its first and
    last columns."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(tokens, e, generator=gen, device=card)
    if ties:
        x[:, 1::2] = x[:, 0:e - e % 2:2]
        x[:, 0] = x[:, -1] = x.max(-1).values + 1
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["no-ties", "ties"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tokens,e,k", [
    (2048, 8, 2),     # the MoE row
    (64, 4, 2), (256, 8, 4), (4096, 64, 6), (4096, 256, 8), (1024, 400, 8),
    (77, 33, 3),      # e not a multiple of 32
    (5, 512, 32),     # the kernels' limits
    (3, 1, 1),
])
def test_moe_route_kernels_are_bit_identical_to_their_plain_versions(card, tokens, e, k, dtype,
                                                                    ties):
    """The route's forward (topw, topi, probs) and backward, each launched
    once, bit for bit their plain versions on the card; topi the lower
    index first among equal values."""
    if ties and e < 2:
        pytest.skip("a tie needs two experts")
    x = _route_logits(card, tokens, e, dtype, ties)
    g = torch.randn(tokens, k, generator=torch.Generator(device=card).manual_seed(12),
                    device=card).to(dtype)
    K.reset_launch_counts()
    got = K.moe_route_fwd(x, k)
    d = K.moe_route_bwd(g, got[2], got[1])
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "moe_route_fwd": 1,
                                 "moe_route_bwd": 1}
    ref = K.moe_route_fwd_plain(x, k)
    d_ref = K.moe_route_bwd_plain(g, ref[2], ref[1])
    for name, a, b in zip(("topw", "topi", "probs", "d_logits"), (*got, d), (*ref, d_ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))
    if ties:
        assert bool((got[1][:, 0] == 0).all() and (got[1][:, 1] == e - 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["random", "all-on-one", "empty-experts"])
@pytest.mark.parametrize("n,e", [(4096, 8), (600, 1), (600, 2), (600, 4), (8192, 64),
                                 (32768, 256), (16384, 400), (65536, 512), (65536, 8),
                                 (1000, 3)])
def test_moe_index_kernel_equals_its_plain_version(card, n, e, keys):
    """The counting sort: order, inv and seg (and the runs of values)
    equal the plain version's (``torch.sort(stable=True)``,
    ``searchsorted``, ``scatter_``), one launch each."""
    gen = torch.Generator(device=card).manual_seed(13)
    if keys == "all-on-one":
        k_ = torch.full((n,), e // 2, dtype=torch.int64, device=card)
    elif keys == "empty-experts":
        k_ = torch.randint(0, max(e // 2, 1), (n,), generator=gen, device=card) * 2 % e
    else:
        k_ = torch.randint(0, e, (n,), generator=gen, device=card)
    values = torch.randint(0, 1000, (n,), generator=gen, device=card)
    K.reset_launch_counts()
    idx = K.moe_index(k_, e, n // e + 3, 2)
    idx_r, runs = K.moe_index_runs(k_, values, e, n // e + 3, 2)
    assert K.launch_counts()["moe_index"] == 2
    ref, runs_ref = K.moe_index_runs_plain(k_, values, e, n // e + 3, 2)
    for a, b, c in zip(idx[:4], idx_r[:4], ref[:4]):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert torch.equal(runs, runs_ref)


def _edge_keys(case, card):
    """(keys, experts) of an index edge case: n about one chunk of the
    kernel (a tile of 1024 keys a block while the tiles fit one a SM) and
    below it, several tiles a block, a chunk without a key, descending
    keys, every key in the last expert, e = 1 and e = 512."""
    gen = torch.Generator(device=card).manual_seed(17)
    n, e = {"chunk-1": (1023, 8), "chunk": (1024, 8), "chunk+1": (1025, 8),
            "below-a-chunk": (100, 8), "two-chunks+1": (2049, 64),
            "several-tiles-a-block": (300000, 256), "a-chunk-without-a-key": (4096, 8),
            "descending": (5000, 64), "all-in-the-last": (3000, 16), "e-1": (2049, 1),
            "e-512": (40000, 512)}[case]
    keys = torch.randint(0, e, (n,), generator=gen, device=card)
    if case == "a-chunk-without-a-key":  # keys 1024 .. 2047 hold no 0 and no 5
        keys[1024:2048] = torch.tensor([1, 2, 3, 4, 6, 7], device=card)[keys[1024:2048] % 6]
    elif case == "descending":
        keys = keys.sort(descending=True).values
    elif case == "all-in-the-last":
        keys.fill_(e - 1)
    return keys, e


@pytest.mark.cuda
@pytest.mark.parametrize("cap", ["at-most-count", "below-count"])
@pytest.mark.parametrize("case", ["chunk-1", "chunk", "chunk+1", "below-a-chunk", "two-chunks+1",
                                  "several-tiles-a-block", "a-chunk-without-a-key",
                                  "descending", "all-in-the-last", "e-1", "e-512"])
def test_moe_index_kernel_at_its_chunk_edges_equals_its_plain_version(card, case, cap):
    """The counting sort spread over the SMs at the edges of its chunks
    (each block's whole tiles), and runs whose cap is above every key's
    count or below the largest: order, inv, seg and runs equal the plain
    version's, one launch a call."""
    keys, e = _edge_keys(case, card)
    n = keys.numel()
    most = int(torch.bincount(keys, minlength=e).max())
    c = most + 3 if cap == "at-most-count" else max(1, most // 2)
    values = torch.randint(0, 1000, (n,), generator=torch.Generator(device=card).manual_seed(18),
                           device=card)
    K.reset_launch_counts()
    idx = K.moe_index(keys, e, c, 1)
    idx_r, runs = K.moe_index_runs(keys, values, e, c, 1)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "moe_index": 2}
    ref, runs_ref = K.moe_index_runs_plain(keys, values, e, c, 1)
    for a, b, r in zip(idx[1:4], idx_r[1:4], ref[1:4]):
        assert torch.equal(a, r) and torch.equal(b, r)
    assert torch.equal(runs, runs_ref)


@pytest.mark.cuda
def test_moe_index_kernel_captured_in_a_graph_replays_as_eager(card):
    """moe_index_runs captured in a CUDA graph on a static key buffer:
    each replay, after new keys are copied in, equals the eager call on
    those keys (and so the plain version)."""
    gen = torch.Generator(device=card).manual_seed(19)
    n, e, cap = 32768, 256, 200
    static_k = torch.randint(0, e, (n,), generator=gen, device=card)
    static_v = torch.randint(0, 1000, (n,), generator=gen, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.moe_index_runs(static_k, static_v, e, cap, 8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        idx, runs = K.moe_index_runs(static_k, static_v, e, cap, 8)
    for seed in range(3):
        g = torch.Generator(device=card).manual_seed(100 + seed)
        static_k.copy_(torch.randint(0, e - seed * 100, (n,), generator=g, device=card))
        static_v.copy_(torch.randint(0, 1000, (n,), generator=g, device=card))
        graph.replay()
        torch.cuda.synchronize()
        eager, eager_runs = K.moe_index_runs(static_k, static_v, e, cap, 8)
        ref, ref_runs = K.moe_index_runs_plain(static_k, static_v, e, cap, 8)
        for a, b, r in zip(idx[1:4], eager[1:4], ref[1:4]):
            assert torch.equal(a, b) and torch.equal(a, r)
        assert torch.equal(runs, eager_runs) and torch.equal(runs, ref_runs)


#: (experts, k) of the route's forward cases: every e of the kernel's
#: instances and their edges, each k up to 32 that e takes
ROUTE_FWD_CASES = [(e, k) for e in (8, 33, 64, 160, 256, 400, 512) for k in (1, 2, 8, 32)
                   if k <= e]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["random", "ties", "underflow"])
@pytest.mark.parametrize("e,k", ROUTE_FWD_CASES, ids=[f"e{e}-k{k}" for e, k in ROUTE_FWD_CASES])
def test_moe_route_forward_selection_is_bit_identical_to_its_plain_version(card, e, k, rows):
    """The route's forward (topw, topi, probs) bit for bit its plain
    version's, one launch a call: rows with exact ties (the lower index
    first) and rows whose smallest probabilities underflow to +0 (top-k
    then takes +0 entries, lowest index first, never a taken one), in
    bf16 and fp32."""
    for dtype in (torch.bfloat16, torch.float32):
        x = _route_logits(card, 96, e, dtype, rows == "ties", seed=e * 100 + k)
        if rows == "underflow":  # about three quarters of each row's logits far below its max
            far = torch.rand(96, e, generator=torch.Generator(device=card).manual_seed(e + k),
                             device=card) < 0.75
            far[:, 0] = False
            x = torch.where(far, x.float() - 300, x.float()).to(dtype)
        K.reset_launch_counts()
        got = K.moe_route_fwd(x, k)
        assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "moe_route_fwd": 1}
        ref = K.moe_route_fwd_plain(x, k)
        for name, a, b in zip(("topw", "topi", "probs"), got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), (name, dtype, int((a != b).sum()))
        if rows == "underflow":
            assert bool((got[2] == 0).any())


@pytest.mark.cuda
def test_moe_route_kernels_raise_for_what_they_refuse(card):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.moe_route_fwd(torch.zeros(4, 8, device=card, dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="at most 512 experts"):
        K.moe_route_fwd(torch.zeros(4, 513, device=card), 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.moe_route_fwd(torch.zeros(8, 4, device=card).t(), 2)
    with pytest.raises(ValueError, match="at most 512 experts"):
        K.moe_index(torch.zeros(8, dtype=torch.int64, device=card), 513, 4, 2)


#: (tokens, experts, k), each run in both dtypes, that with the rows above
#: them in ``ROUTE_BWD_CASES`` reach every instance of the route backward
#: that a call can reach: 16 and 32 lanes a token (up to 16 and 17 to 32
#: experts) at k up to 8 and past it, and 1 to 4 groups of 4 experts a
#: lane at k up to 8 and past it
ROUTE_BWD_INSTANCE_CASES = [(100, 12, 2), (100, 16, 12), (300, 24, 2), (300, 32, 8),
                            (100, 32, 20), (200, 100, 4), (100, 33, 9), (200, 200, 16),
                            (200, 256, 8), (200, 384, 8), (100, 300, 12)]
#: (tokens, experts, k, dtype, ties) of the route's backward: the cases of
#: ``chip_smoke.py``'s phase 3f (``ROUTE_CASES``), the kernels' limits (512
#: experts top-32, in both dtypes), rows of 5 experts (no row 16-byte
#: aligned), of 16 (two tokens a warp), and ``ROUTE_BWD_INSTANCE_CASES``
ROUTE_BWD_CASES = [
    (2048, 8, 2, torch.bfloat16, False), (2048, 8, 2, torch.float32, False),
    (128, 4, 2, torch.float32, False), (64, 4, 2, torch.bfloat16, False),
    (256, 8, 4, torch.bfloat16, False), (4096, 64, 6, torch.bfloat16, False),
    (4096, 256, 8, torch.bfloat16, False), (1024, 400, 8, torch.bfloat16, False),
    (2048, 8, 2, torch.bfloat16, True), (1024, 400, 8, torch.float32, True),
    (5, 512, 32, torch.bfloat16, False), (5, 512, 32, torch.float32, False),
    (300, 5, 2, torch.bfloat16, False), (300, 5, 3, torch.float32, False),
    (100, 16, 2, torch.bfloat16, False),
] + [(t, e, k, dtype, False) for t, e, k in ROUTE_BWD_INSTANCE_CASES
     for dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "probs-off-16-bytes"])
@pytest.mark.parametrize("tokens,e,k,dtype,ties", ROUTE_BWD_CASES,
                         ids=[f"T{t}-e{e}-k{k}-{str(d)[6:]}{'-ties' if ties else ''}"
                              for t, e, k, d, ties in ROUTE_BWD_CASES])
def test_moe_route_backward_is_bit_identical_to_its_plain_version(card, tokens, e, k, dtype,
                                                                   ties, offset):
    """``moe_route_bwd`` on the forward's probs and topi, launched once, bit
    for bit ``moe_route_bwd_plain`` on the card and on the CPU; with probs
    one element into its buffer, the loads of the same kernel without
    16-byte words."""
    x = _route_logits(card, tokens, e, dtype, ties, seed=16)
    _topw, topi, probs = K.moe_route_fwd(x, k)
    if offset:
        probs = torch.empty(probs.numel() + offset, device=card)[offset:].view(tokens, e)
        probs.copy_(K.moe_route_fwd(x, k)[2])
    g = torch.randn(tokens, k, generator=torch.Generator(device=card).manual_seed(17),
                    device=card).to(dtype)
    K.reset_launch_counts()
    d = K.moe_route_bwd(g, probs, topi)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "moe_route_bwd": 1}
    d_ref = K.moe_route_bwd_plain(g, probs, topi)
    assert d.dtype == dtype and d.shape == (tokens, e)
    assert torch.equal(d, d_ref), int((d != d_ref).sum())
    assert torch.equal(K.moe_route_bwd_plain(g.cpu(), probs.cpu(), topi.cpu()), d.cpu())


@pytest.mark.cuda
def test_moe_route_backward_refuses_what_the_kernel_does_not_take(card):
    topi = torch.zeros(4, 2, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="at most 512 experts"):
        K.moe_route_bwd(torch.zeros(4, 2, device=card), torch.zeros(4, 513, device=card), topi)
    with pytest.raises(ValueError, match="at most 512 experts and 32 a token"):
        K.moe_route_bwd(torch.zeros(4, 33, device=card), torch.zeros(4, 64, device=card),
                        torch.zeros(4, 33, dtype=torch.int64, device=card))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.moe_route_bwd(torch.zeros(4, 2, device=card, dtype=torch.float16),
                        torch.zeros(4, 8, device=card), topi)
    with pytest.raises(ValueError, match="contiguous"):
        K.moe_route_bwd(torch.zeros(2, 4, device=card).t(), torch.zeros(4, 8, device=card), topi)


@pytest.mark.cuda
@pytest.mark.parametrize("probs", [False, True], ids=["weighted-combine", "dispatch_probs"])
def test_the_a2a_dispatch_runs_the_kernels_and_no_index_put(card, probs):
    """One a2a step of the manual-parallel model on the card (world 1)
    launches the route, index, permute and combine kernels once a MoE
    layer each way and records no sort, ``searchsorted``, ``index_add``,
    top-k or softmax, and no more ``index_put`` calls than the psum
    step (the embedding's backward, which takes the out-of-place
    ``index_put`` while a dispatch mode records), and its loss is
    finite."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    from simumax_tpu_torch.torchref import parallel as T

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    ids = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(0))
    runs = {}
    for dispatch in ("psum", "a2a"):
        cfg = T.PPConfig(vocab_size=512, hidden_size=128, head_num=2, head_size=64,
                         intermediate_size=256, moe_ffn=128, expert_num=4, dtype=torch.float32,
                         ep_dispatch=dispatch, dispatch_probs=probs and dispatch == "a2a")
        with T.process_group("cuda"):
            mesh = T.make_pp_mesh(1, pp=1, tp=1, ep=1, device="cuda")
            params, specs = T.init_pp_params(cfg, mesh, torch.Generator().manual_seed(0))
            K.reset_launch_counts()
            with Record() as rec:
                _new, loss = T.make_pp_train_step(cfg, mesh, lr=1.0)(specs)(params, ids, ids)
            runs[dispatch] = (K.launch_counts(), rec.ops, float(loss))
    counts, ops, loss = runs["a2a"]
    assert {k: counts[k] for k in MOE_KERNELS + ROUTE_KERNELS} == dict.fromkeys(
        MOE_KERNELS + ROUTE_KERNELS, 1)
    assert not {op for op in ("sort", "searchsorted", "index_add", "index_add_", "topk",
                              "_softmax") if ops[op]}, ops
    psum_ops = runs["psum"][1]
    assert ops["index_put"] <= psum_ops["index_put"] and ops["index_put_"] <= psum_ops[
        "index_put_"], (ops, psum_ops)
    assert math.isfinite(loss)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,causal", [
    (1, 1024, 1024, 2, True),    # 16 kv tiles, the causal skip
    (2, 320, 320, 3, True),      # s = 64 mod 128
    (1, 512, 512, 2, False),     # non-causal
    (1, 128, 320, 2, True),      # more keys than queries
    (2, 320, 128, 2, True),      # more queries than keys
    (1, 8192, 8192, 2, True),    # the Moonlight cell's sequence, two of its heads
])
def test_bf16_flash_kernels_at_192_128_match_plain_versions(card, b, sq, skv, h, causal):
    """The latent-attention pair: q and k heads of 192, v heads of 128, the
    forward, dq and dk/dv launched once each, against the plain versions at
    that pair (o, do and dv 128 wide) within two bf16 ulps, rtol 2^-6: P
    and dS round to bf16 on both sides from fp32 scores summed in other
    orders over 192 terms, and a value on a rounding edge that rounds apart
    carries one bf16 ulp of its term into the sum (read on the card: 1.06
    of the one-ulp limit at one element in 10^6, the kernels as far from
    exact fp32 attention as the plain versions)."""
    gen = torch.Generator(device=card).manual_seed(3)
    q = torch.randn(b, sq, h, 192, generator=gen, device=card).bfloat16()
    k = torch.randn(b, skv, h, 192, generator=gen, device=card).bfloat16()
    v = torch.randn(b, skv, h, 128, generator=gen, device=card).bfloat16()
    do = torch.randn(b, sq, h, 128, generator=gen, device=card).bfloat16()
    K.reset_launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal)
    delta = K.flash_delta(o_ref, do)
    dq = K.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dq_ref = K.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    dk_ref, dv_ref = K.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "flash_fwd": 1,
                                 "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert _within(lse, lse_ref, 1e-4)
    assert o.shape == (b, sq, h, 128) and dv.shape == v.shape and dk.shape == k.shape
    for got, ref in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _within(got, ref, 2 ** -6)


@pytest.mark.cuda
def test_flash_at_192_128_refuses_fp32_and_other_pairs(card):
    """The fp32 kernels take equal heads only, and no other unequal pair is
    instantiated: each raises, and ``attention`` with ``use_flash=True``
    raises rather than taking math attention or a padded v."""
    q = torch.randn(1, 128, 2, 192, device=card)
    k, v = torch.randn_like(q), torch.randn(1, 128, 2, 128, device=card)
    with pytest.raises(ValueError, match="fp32 kernels"):
        K.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="fp32 kernels"):
        K.attention(q, k, v, use_flash=True)
    qb = torch.randn(1, 128, 2, 128, device=card).bfloat16()
    with pytest.raises(ValueError, match="does not take"):
        K.flash_fwd(qb, qb, torch.randn(1, 128, 2, 64, device=card).bfloat16())


def _sigmoid_route_inputs(card, tokens, e, k, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(tokens, e, generator=gen, device=card).to(dtype)
    bias = 0.05 * torch.randn(e, generator=gen, device=card)
    g = torch.randn(tokens, k, generator=gen, device=card).to(dtype)
    return x, bias, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens,e,k", [(8192, 64, 6), (2048, 8, 2), (77, 33, 3), (5, 512, 32),
                                        (4096, 256, 8)])
def test_sigmoid_route_kernels_are_bit_identical_to_their_plain_versions(card, tokens, e, k,
                                                                        dtype):
    """The sigmoid route's forward (topw, topi, scores) and backward, each
    launched once, bit for bit their plain versions on the card."""
    x, bias, g = _sigmoid_route_inputs(card, tokens, e, k, dtype, 21)
    K.reset_launch_counts()
    got = K.moe_route_sigmoid_fwd(x, bias, k, 2.446)
    d = K.moe_route_sigmoid_bwd(g, got[2], got[1], 2.446)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "moe_route_sigmoid_fwd": 1,
                                 "moe_route_sigmoid_bwd": 1}
    ref = K.moe_route_sigmoid_fwd_plain(x, bias, k, 2.446)
    d_ref = K.moe_route_sigmoid_bwd_plain(g, ref[2], ref[1], 2.446)
    for name, a, b in zip(("topw", "topi", "scores", "d_logits"), (*got, d), (*ref, d_ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("held", [(0, 8), (8, 8), (56, 8), (0, 64), (3, 5)])
@pytest.mark.parametrize("n,e,k", [(8192 * 6, 64, 6), (600, 64, 3), (5000, 16, 2)])
def test_moe_index_kernel_of_held_experts_equals_its_plain_version(card, n, e, k, held):
    """The index of experts [first, first + count): order, inv, seg and the
    held experts' ids equal the plain version's, one launch; the capacity
    buffer it dispatches into is the full index's rows of those experts."""
    first, count = held
    if first + count > e:
        pytest.skip("more experts held than the layer has")
    gen = torch.Generator(device=card).manual_seed(19)
    keys = torch.randint(0, e, (n,), generator=gen, device=card)
    cap = int(2.0 * n / e)
    K.reset_launch_counts()
    idx = K.moe_index(keys, e, cap, k, held)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "moe_index_held": 1}
    ref = K.moe_index_plain(keys, e, cap, k, held)
    for name, a, b in zip(("flat_e", "order", "inv", "seg"), idx[:4], ref[:4]):
        assert torch.equal(a, b), name
    y = torch.randn(n // k, 64, generator=gen, device=card).bfloat16()
    full = K.moe_index(keys, e, cap, k)
    assert torch.equal(K.moe_permute(y, None, idx),
                       K.moe_permute(y, None, full)[first:first + count])


@pytest.mark.cuda
def test_mla_moe_step_on_the_card_matches_the_cpu(card):
    """One fp32 Adam step of the latent-attention MoE model (flash at
    equal heads of 64, which the fp32 kernels take, the sigmoid route, 4 of
    16 experts held) on the card against the same step on the CPU (the
    flash kernels' plain versions), as the MoE reference's test holds it:
    the loss to rel 1e-5, every updated parameter to 1e-4 (|cpu| +
    rms(cpu)), 2 lr where the first moment is near 0."""
    from simumax_tpu_torch.torchref import mla_moe_model as M

    cfg = M.MlaMoeConfig(vocab_size=512, hidden_size=256, num_attention_heads=2,
                         qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=64,
                         kv_lora_rank=64, num_hidden_layers=3, intermediate_size=256,
                         moe_intermediate_size=64, n_routed_experts=16, experts_held=(4, 4),
                         correction_bias_std=0.05, capacity_factor=1.0, dtype=torch.float32)
    params = M.init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, 512, (2, 64), generator=torch.Generator().manual_seed(0))
    lr, results = 1e-2, {}
    for device in ("cuda", "cpu"):
        init_opt, step = M.make_train_step(cfg, lr=lr)
        p = _tree_to(params, device)
        new, opt, loss = step(p, init_opt(p), (ids.to(device), ids.to(device)))
        results[device] = (float(loss), [x.detach().cpu() for x in M.param_leaves(new)],
                           [x.cpu() for x in M.param_leaves(opt["mu"])])
    (loss_gpu, new_gpu, _), (loss_cpu, new_cpu, mu_cpu) = results["cuda"], results["cpu"]
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for got, ref, mu in zip(new_gpu, new_cpu, mu_cpu):
        limit = 1e-4 * (ref.abs() + ref.square().mean().sqrt())
        limit = limit.where(mu.abs() >= 1e-3 * mu.abs().max(), limit.new_tensor(2 * lr))
        assert bool(((got - ref).abs() <= limit).all())
