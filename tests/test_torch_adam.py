"""The Adam update of the port's training step: ``csrc/adam.cu``'s
``adam_multi_tensor_kernel`` against its plain PyTorch version
(``torchref/kernels.py::adam_update_plain``), and what the wrapper
refuses. The plain version against the JAX package is in
``tests/test_torch_step.py``; this file imports no jax, so its card tests
also run on a machine with only PyTorch:
``python -m pytest -m cuda tests/test_torch_adam.py``.

Tolerances: none. On the CPU the plain version's moments equal a numpy
float32 walk of the same rounded operations bit for bit, and each
parameter equals the walk's with the square root correctly rounded or
one ulp to either side of it (ATen's vectorised sqrt on the CPU is not
always correctly rounded); on the card the
kernel equals the plain version bit for bit at every leaf, dtype and
step, and a captured update replayed N times equals N eager updates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simumax_tpu_torch.torchref import kernels as K  # noqa: E402
from simumax_tpu_torch.torchref import model as M  # noqa: E402

#: leaf sizes about the kernel's chunk (2048 elements) and vector (8)
SIZES = (1, 7, 2049, 65537)
LR = 1e-2


def _leaves(sizes, dtype, device, seed=0, offset=0, moments=True):
    """(params, grads, mu, nu) of the given sizes, each tensor a
    contiguous view ``offset`` elements into a buffer of its own (an odd
    offset: bases that are not 16-byte aligned); nonzero moments unless
    ``moments`` is False."""
    rs = np.random.RandomState(seed)

    def at(a, dt):
        buf = torch.empty(a.size + offset, dtype=dt, device=device)
        t = buf[offset:]
        t.copy_(torch.from_numpy(a).to(dt))
        return t

    out = ([], [], [], [])
    for n in sizes:
        g = rs.randn(n).astype(np.float32) * np.float32(10 ** rs.uniform(-3, 1))
        m = rs.randn(n).astype(np.float32) * np.float32(0.1) if moments else np.zeros(n, np.float32)
        v = (rs.randn(n).astype(np.float32) * np.float32(0.1)) ** 2 if moments else m.copy()
        for lst, a, dt in zip(out, (rs.randn(n).astype(np.float32), g, m, v),
                              (dtype, dtype, torch.float32, torch.float32)):
            lst.append(at(a, dt))
    return out


def _bias_corrections(step, device):
    t = torch.tensor(step, dtype=torch.int32, device=device).float()
    return (1 - torch.full_like(t, K.ADAM_B1).pow(t), 1 - torch.full_like(t, K.ADAM_B2).pow(t))


def _numpy_update(p, g, m, v, bc1, bc2):
    """The update as numpy float32 operations, one rounding each, in the
    plain version's order: (p with the square root correctly rounded, p
    with it one ulp below, one ulp above), mu, nu."""
    f = np.float32
    g = g.astype(np.float32)
    m = m * f(K.ADAM_B1) + g * f(1 - K.ADAM_B1)
    v = v * f(K.ADAM_B2) + (g * g) * f(1 - K.ADAM_B2)
    root = np.sqrt(v / f(bc2))
    ps = tuple(p.astype(np.float32) - ((m / f(bc1)) * f(LR)) / (r + f(K.ADAM_EPS))
               for r in (root, np.nextafter(root, f(0)), np.nextafter(root, f(np.inf))))
    return ps, m, v


@pytest.mark.parametrize("step", [1, 2, 1000])
def test_plain_update_is_the_numpy_walk_of_its_operations(step):
    """fp32 leaves on the CPU: the plain version's mu and nu equal the
    numpy float32 walk bit for bit (each PyTorch op one IEEE operation in
    JAX's order), and p the walk's up to the rounding of the square root."""
    params, grads, mu, nu = _leaves(SIZES, torch.float32, "cpu", seed=step)
    want = [_numpy_update(*(t.numpy().copy() for t in leaf),
                          *(float(b) for b in _bias_corrections(step, "cpu")))
            for leaf in zip(params, grads, mu, nu)]
    K.reset_launch_counts()
    K.adam_multi_tensor(params, grads, mu, nu, *_bias_corrections(step, "cpu"), LR)
    assert all(n == 0 for n in K.launch_counts().values())  # the CPU runs the plain version
    for (ps, m, v), (p, m_got, v_got) in zip(want, zip(params, mu, nu)):
        assert np.array_equal(m, m_got.numpy()) and np.array_equal(v, v_got.numpy())
        got = p.numpy()
        assert ((got == ps[0]) | (got == ps[1]) | (got == ps[2])).all()


def _refused(params, grads, mu, nu, bc, match):
    before = [t.clone() for t in params + mu + nu]
    K.reset_launch_counts()
    with pytest.raises(K.KernelError, match=match):
        K.adam_multi_tensor(params, grads, mu, nu, *bc, LR)
    assert all(n == 0 for n in K.launch_counts().values())
    # nothing was updated, the good leaves before the refused one neither
    assert all(torch.equal(a, b) for a, b in zip(before, params + mu + nu))


@pytest.mark.parametrize("what", ["bf16 p, fp32 g", "fp32 p, bf16 g", "fp16 p", "bf16 mu",
                                  "fp64 nu"])
def test_the_wrapper_refuses_another_dtype_pairing_before_any_update(what):
    params, grads, mu, nu = _leaves((7, 2049), torch.bfloat16, "cpu")
    if what == "bf16 p, fp32 g":
        grads[1] = grads[1].float()
    elif what == "fp32 p, bf16 g":
        params[1] = params[1].float()
    elif what == "fp16 p":
        params[1], grads[1] = params[1].half(), grads[1].half()
    elif what == "bf16 mu":
        mu[1] = mu[1].bfloat16()
    else:
        nu[1] = nu[1].double()
    _refused(params, grads, mu, nu, _bias_corrections(3, "cpu"), "leaf 1 has")


@pytest.mark.parametrize("which", range(4), ids=["p", "g", "mu", "nu"])
def test_the_wrapper_refuses_a_non_contiguous_leaf_before_any_update(which):
    leaves = _leaves((7, 64), torch.float32, "cpu")
    leaves[which][1] = torch.empty(128, dtype=leaves[which][1].dtype)[::2].copy_(
        leaves[which][1])
    assert not leaves[which][1].is_contiguous()
    _refused(*leaves, _bias_corrections(3, "cpu"), "not contiguous")


def test_the_wrapper_refuses_shapes_lengths_and_bias_corrections():
    params, grads, mu, nu = _leaves((7, 64), torch.float32, "cpu")
    bc = _bias_corrections(3, "cpu")
    _refused(params, grads, mu, nu[:1], bc, "1 nu")
    _refused(params, [grads[0], grads[1].reshape(8, 8)], mu, nu, bc, "differ")
    _refused(params, grads, mu, nu, (bc[0].double(), bc[1]), "bc1 must be a float32 scalar")
    _refused(params, grads, mu, nu, (bc[0], bc[1].expand(2)), "bc2 must be a float32 scalar")


def test_the_step_routes_cpu_leaves_to_the_plain_version():
    """``model.adam_update`` on CPU leaves: the plain version, no launch,
    and the same bits as calling it with the step's bias corrections."""
    a = _leaves(SIZES, torch.bfloat16, "cpu", seed=5)
    b = [[t.clone() for t in ts] for ts in a]
    step = torch.tensor(4, dtype=torch.int32)
    K.reset_launch_counts()
    M.adam_update(*a, step, lr=LR)
    assert all(n == 0 for n in K.launch_counts().values())
    K.adam_update_plain(*b, *_bias_corrections(4, "cpu"), LR)
    assert all(torch.equal(x, y) for x, y in zip(a[0] + a[2] + a[3], b[0] + b[2] + b[3]))


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal_leaves(got, ref):
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd offset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_kernel_is_bit_identical_to_the_plain_version(card, dtype, offset, step):
    """Leaves of 1, 7, 2049 and 65537 elements (at 16-byte aligned bases
    and one element off them), zero moments at step 1 and nonzero ones
    after: p, mu and nu equal the plain version's bit for bit, in one
    launch."""
    leaves = _leaves(SIZES, dtype, card, seed=step, offset=offset, moments=step > 1)
    ref = [[t.clone() for t in ts] for ts in leaves]
    bc = _bias_corrections(step, card)
    K.reset_launch_counts()
    K.adam_multi_tensor(*leaves, *bc, LR)
    assert K.launch_counts() == {**dict.fromkeys(K.LAUNCHES, 0), "adam_multi_tensor": 1}
    K.adam_update_plain(*ref, *bc, LR)
    torch.cuda.synchronize()
    for i in (0, 2, 3):
        assert _equal_leaves(leaves[i], ref[i]), i


@pytest.mark.cuda
def test_kernel_takes_mixed_dtypes_in_one_launch_each(card):
    """bf16 and fp32 leaves in one list: one launch a dtype, each leaf bit
    for bit the plain version; over 256 leaves of a dtype, a launch per
    256."""
    a = _leaves((7, 2049), torch.bfloat16, card, seed=1)
    b = _leaves((65537, 1), torch.float32, card, seed=2)
    leaves = [x + y for x, y in zip(a, b)]
    ref = [[t.clone() for t in ts] for ts in leaves]
    bc = _bias_corrections(3, card)
    K.reset_launch_counts()
    K.adam_multi_tensor(*leaves, *bc, LR)
    assert K.launch_counts()["adam_multi_tensor"] == 2
    K.adam_update_plain(*ref, *bc, LR)
    for i in (0, 2, 3):
        assert _equal_leaves(leaves[i], ref[i])
    many = _leaves([3] * 300, torch.bfloat16, card, seed=3)
    ref = [[t.clone() for t in ts] for ts in many]
    K.reset_launch_counts()
    K.adam_multi_tensor(*many, *bc, LR)
    assert K.launch_counts()["adam_multi_tensor"] == 2
    K.adam_update_plain(*ref, *bc, LR)
    for i in (0, 2, 3):
        assert _equal_leaves(many[i], ref[i])


@pytest.mark.cuda
def test_kernel_refuses_on_the_card_what_it_does_not_take(card):
    params, grads, mu, nu = _leaves((7, 64), torch.bfloat16, card)
    grads[1] = grads[1].float()
    _refused(params, grads, mu, nu, _bias_corrections(3, card), "leaf 1 has")
    params, grads, mu, nu = _leaves((7, 64), torch.float32, card)
    _refused(params, grads, mu, nu, _bias_corrections(3, "cpu"), "not wholly on")


def _update_fn(leaves, bases, step):
    """One update as a training step runs it: the step count incremented
    on the card and the gradients allocated afresh (in a capture, from the
    graph's pool)."""
    params, mu, nu = leaves

    def run():
        step.add_(1)
        grads = [b * 1.5 for b in bases]
        M.adam_update(params, grads, mu, nu, step, lr=LR)

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_captured_update_replayed_equals_eager_updates(card, dtype):
    """A captured update (step count and gradients made inside it)
    replayed 3 times after one warm-up update equals 4 eager updates bit
    for bit, the step count included; the capture itself runs nothing."""
    p, g, m, v = _leaves(SIZES, dtype, card, seed=7, moments=False)
    eager = ([t.clone() for t in p], [t.clone() for t in m], [t.clone() for t in v])
    eager_step = torch.zeros((), dtype=torch.int32, device=card)
    run = _update_fn(eager, g, eager_step)
    for _ in range(4):
        run()
    step = torch.zeros((), dtype=torch.int32, device=card)
    run = _update_fn((p, m, v), g, step)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # the warm-up update makes the leaf table
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = [t.clone() for t in p + m + v]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    torch.cuda.synchronize()
    assert int(step) == 1 and all(torch.equal(a, b) for a, b in zip(before, p + m + v))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert int(step) == int(eager_step) == 4
    for got, ref in zip((p, m, v), eager):
        assert _equal_leaves(got, ref)


@pytest.mark.cuda
def test_capture_without_a_table_raises(card):
    """The leaf table is made outside captures: an update whose leaves
    have none raises inside a capture instead of allocating."""
    p, g, m, v = _leaves((7,), torch.float32, card, seed=11)
    step = torch.zeros((), dtype=torch.int32, device=card)
    run = _update_fn((p, m, v), g, step)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(K.KernelError, match="capture"):
        with torch.cuda.graph(graph):
            run()
