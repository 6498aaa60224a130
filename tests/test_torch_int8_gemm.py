"""The int8 path's product on the CPU: ``kernels.int8_gemm`` (its plain
version here; ``csrc/int8_gemm.cu`` on the card), the operands it takes
on every device (``kernels.check_int8_gemm_layout``), and ``quantized._mm``
handing it every product.

* ``int8_gemm_plain`` is the exact int32 product: equal to an int64
  product computed in numpy, at the int8 step's layouts scaled down, at
  tails of every size, and with every operand at +-127, where the sums
  come within 0.02% of int32's limit.
* ``int8_gemm`` takes its operands by shapes, strides and bases alone:
  the orders the quantizer writes, n a multiple of 4, row strides that
  are both multiples of 16 bytes (TMA's loads) or both 8 past one (TMA's
  loads of the even rows, 8-byte copies of the odd ones: Aquila2's LM
  head dgrad at 100008 bytes), 16-byte aligned bases; it raises on any
  other operands, here as on the card.
* ``_mm`` hands every product to ``int8_gemm``, with no other route: one
  int8 step runs every product there, and an operand the kernel does not
  take raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch.torchref import kernels as K  # noqa: E402
from simumax_tpu_torch.torchref import model as TM  # noqa: E402
from simumax_tpu_torch.torchref import quantized as TQ  # noqa: E402

#: [m, k, n] products: the int8 step's three layouts at hidden 128, ffn
#: 344 and 2000 tokens' worth of rows scaled down, and tails of m, n and k
SHAPES = [(256, 128, 384), (256, 344, 128), (128, 256, 344), (24, 48, 40), (8200 // 64, 136, 100),
          (17, 8, 8), (33, 24, 10), (25, 40, 37), (1, 16, 1), (130, 1000, 258)]
#: Aquila2's products as the kernel gets them, the sizes scaled down to
#: keep their strides' residues: (m, k, n) with k or n of 100008 cut to
#: 1064 (= 8 mod 16, as 100008)
AQUILA_HEAD = {"forward": (64, 4096 // 64, 1064), "dgrad": (64, 1064, 4096 // 64),
               "wgrad": (4096 // 64, 64, 1064)}


def _operands(m, k, n, seed=0, fill=None):
    gen = torch.Generator().manual_seed(seed)
    if fill is None:
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    else:
        a, bt = (torch.full(s, v, dtype=torch.int8) for s, v in (((m, k), fill[0]),
                                                                  ((n, k), fill[1])))
    return a, bt.t()  # b column-major, as the quantizer writes it


def _int64(a, b):
    return a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)


@pytest.mark.parametrize("m,k,n", SHAPES + list(AQUILA_HEAD.values()))
def test_the_plain_product_is_the_int64_product(m, k, n):
    a, b = _operands(m, k, n, seed=m + k + n)
    got = K.int8_gemm_plain(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert np.array_equal(got.numpy().astype(np.int64), _int64(a, b))
    if n % 4:
        with pytest.raises(ValueError, match="multiple of 4"):
            K.int8_gemm(a, b)
    else:
        assert torch.equal(K.int8_gemm(a, b), got)


@pytest.mark.parametrize("fill", [(127, 127), (127, -127), (-127, -127)])
def test_the_plain_product_holds_the_largest_sums(fill):
    """k = 133120: |sum| = 127^2 k = 2,147,092,480, 391,168 under 2^31."""
    k = 133120
    a, b = _operands(2, k, 3, fill=fill)
    want = fill[0] * fill[1] * k
    assert abs(want) < 2 ** 31 and 2 ** 31 - abs(want) < 2 ** 31 * 2e-4
    assert np.array_equal(_int64(a, b), np.full((2, 3), want))
    assert torch.equal(K.int8_gemm_plain(a, b), torch.full((2, 3), want, dtype=torch.int32))


def test_the_plain_product_refuses_what_is_not_an_int8_product():
    a, b = _operands(4, 16, 8)
    for x, y in ((a.float(), b), (a, b[:8]), (a[0], b), (a, b.to(torch.int16))):
        with pytest.raises(ValueError, match="int8_gemm"):
            K.int8_gemm_plain(x, y)


@pytest.mark.parametrize("layout", sorted(AQUILA_HEAD))
def test_the_route_takes_aquila2s_lm_head_products(layout):
    """Every layout of the LM head's product, as ``_mm`` hands it over:
    the dgrad's operands' rows are 8 mod 16 bytes long (100008), whose odd
    rows only the kernel's 8-byte copies take, the other two TMA's."""
    m, k, n = AQUILA_HEAD[layout]
    a, b = _operands(m, k, n)
    assert torch.equal(K.int8_gemm(a, b), K.int8_gemm_plain(a, b))
    assert (k % 16 == 0) is (layout != "dgrad")
    full = {"forward": (8192, 4096, 100008), "dgrad": (8192, 100008, 4096),
            "wgrad": (4096, 8192, 100008)}[layout]
    assert full[1] % 16 == k % 16


@pytest.mark.parametrize("m,k,n", [(8192, 4096, 12288), (8192, 11008, 4096), (4096, 8192, 22016),
                                   (8192, 4096, 100008), (8192, 100008, 4096),
                                   (4096, 8192, 100008)])
def test_the_route_takes_the_cells_layouts_by_shape_and_stride(m, k, n):
    """Meta tensors: the int8 cell's full shapes, with the strides the
    quantizer writes (no memory behind them), the LM head's dgrad with
    rows of 100008 bytes among them."""
    a = torch.empty((m, k), dtype=torch.int8, device="meta")
    b = torch.empty((n, k), dtype=torch.int8, device="meta").t()
    assert a.stride(0) == b.stride(1) == k
    K.check_int8_gemm_layout(a, b)


def _refused():
    """(name, a, b) the kernel refuses."""
    a, b = _operands(32, 48, 40)
    flat = torch.zeros(32 * 48 + 8, dtype=torch.int8)
    shifted = flat[8:].view(32, 48)  # a base 8 bytes off 16
    a12, b12 = _operands(32, 12, 8)
    return [("n not a multiple of 4", a, _operands(32, 48, 42)[1]),
            ("first operand column-major", a.t().contiguous().t(), b),
            ("second operand row-major", a, b.contiguous()),
            ("rows of 12 bytes", a12, b12),
            ("a base 8 bytes off 16", shifted, b),
            ("int16 operands", a.to(torch.int16), b.to(torch.int16)),
            ("inner sizes differ", a, _operands(32, 40, 40)[1])]


@pytest.mark.parametrize("case", range(7))
def test_the_route_refuses_by_order_stride_and_base(case):
    _name, a, b = _refused()[case]
    with pytest.raises(ValueError, match="int8_gemm"):
        K.int8_gemm(a, b)


def _takes(a, b) -> bool:
    try:
        K.check_int8_gemm_layout(a, b)
    except ValueError:
        return False
    return True


def test_the_route_takes_eight_byte_rows_only_with_whole_pieces():
    """Row strides 8 mod 16 send the odd rows to the 8-byte copies, which
    need k to be a multiple of 8 (k 20 in rows of 24 bytes is refused, k
    24 taken) and both operands' strides alike; one row has no odd row."""
    rows = torch.zeros(32, 24, dtype=torch.int8)
    cols = torch.zeros(40, 24, dtype=torch.int8)
    assert _takes(rows, cols.t())
    assert not _takes(rows[:, :20], cols[:, :20].t())
    assert _takes(torch.zeros(32, 32, dtype=torch.int8)[:, :20],
                  torch.zeros(40, 32, dtype=torch.int8)[:, :20].t())
    assert not _takes(rows, torch.zeros(40, 32, dtype=torch.int8)[:, :24].t())
    assert _takes(rows[:1], cols.t())


@pytest.fixture
def gemm_calls(monkeypatch):
    """The products ``quantized._mm`` hands ``kernels.int8_gemm``, counted
    in a one-element list."""
    fn, calls = TQ.int8_gemm, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(TQ, "int8_gemm", counted)
    return calls


def test_mm_hands_every_product_to_the_int8_gemm(gemm_calls):
    """No other route: an operand the kernel does not take (a base 8 bytes
    off 16) raises in ``_mm`` too."""
    a, b = _operands(32, 48, 40)
    ref = torch.from_numpy(_int64(a, b).astype(np.int32))
    assert torch.equal(TQ._mm(a, b), ref)
    shifted = torch.zeros(32 * 48 + 8, dtype=torch.int8)[8:].view(32, 48)
    shifted.copy_(a)
    with pytest.raises(ValueError, match="aligned bases"):
        TQ._mm(shifted, b)
    assert gemm_calls == [2]


@pytest.mark.parametrize("vocab", [256, 264])  # 264: 8 mod 16, as Aquila2's 100008
def test_one_int8_step_runs_every_product_on_the_int8_gemm(vocab, gemm_calls):
    cfg = TM.LlamaConfig(vocab_size=vocab, hidden_size=64, head_num=2, kv_head_num=1,
                         head_size=32, intermediate_size=128, layer_num=2,
                         dtype=torch.bfloat16, use_int8=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    init_opt, step = TM.make_train_step(cfg)
    opt = init_opt(params)
    ids = torch.randint(0, vocab, (1, 32), generator=torch.Generator().manual_seed(0))
    step(params, opt, (ids, ids))
    products = 3 * (4 * cfg.layer_num + 1)  # forward, dgrad, wgrad of each linear layer
    assert gemm_calls == [products]
