"""The pipeline-schedule folds of the port's batched search
(``search/batched.py``: ``fold_table``, ``fold_levels``,
``_fold_members_cuda``) and the
plain version of their CUDA kernel (``torchref/kernels.py``:
``fold_schedule_plain``), held against the JAX package's numpy folds.

Cases: a seeded fuzz over pp 2-8, vp 1-4, mbc up to 64, the vpp group
size, async and blocking p2p, several candidates a shape; and the
scores of ``BatchedScorer(device="cpu", backend="cuda")`` (the plain
version wherever the kernel would run) on the JAX package's jit and VPP
families (``tests/test_batched.py``: ``TestJitBackend``) against the JAX
package's ``backend="numpy"``. The JAX package's jitted folds are no
oracle here: they need ``jax.experimental.enable_x64``, which this jax
lacks. The JAX package pins its numpy fold to them bit for bit.

Tolerance: none. The plain version and the numpy fold make the same
float64 additions and comparisons on the same values, so every total,
end and score is equal with ``==``.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simumax_tpu.core.config import get_model_config as jax_model  # noqa: E402
from simumax_tpu.core.config import get_system_config as jax_system  # noqa: E402
from simumax_tpu.core.config import get_strategy_config as jax_strategy  # noqa: E402
from simumax_tpu.search import batched as jb  # noqa: E402
from simumax_tpu_torch.core.config import get_model_config, get_strategy_config  # noqa: E402
from simumax_tpu_torch.core.config import get_system_config  # noqa: E402
from simumax_tpu_torch.search import batched as tb  # noqa: E402
from simumax_tpu_torch.torchref import kernels as K  # noqa: E402

SCORE_KEYS = ("iter_time", "mfu", "tgs", "max_peak_bytes", "fits_margin_bytes")


def _fuzz_cases(seed, count):
    rng = random.Random(seed)
    for _ in range(count):
        pp = rng.choice([2, 3, 4, 8])
        vp = rng.choice([1, 1, 2, 3, 4])
        if vp == 1:
            group, mbc = 0, rng.randint(1, 64)
        else:
            group = pp * rng.choice([1, 2])
            mbc = group * rng.randint(1, max(1, 64 // group))
        n = rng.randint(1, 5)
        fwd = [[[rng.uniform(0.01, 5.0) for _ in range(n)] for _ in range(vp)]
               for _ in range(pp)]
        bwd = [[[rng.uniform(0.01, 5.0) for _ in range(n)] for _ in range(vp)]
               for _ in range(pp)]
        p2p = [rng.uniform(0.0, 2.0) for _ in range(n)]
        asy = [rng.random() < 0.5 for _ in range(n)]
        yield pp, vp, mbc, group, fwd, bwd, p2p, asy


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_fold_is_the_numpy_fold_bit_for_bit(seed):
    for pp, vp, mbc, group, fwd, bwd, p2p, asy in _fuzz_cases(seed, 12):
        ops = torch.from_numpy(tb.fold_levels(tb.fold_table(pp, vp, mbc, group))[0])
        assert ops.shape == (2 * pp * vp * mbc, 4)
        out = K.fold_schedule(
            ops, torch.tensor(fwd, dtype=torch.float64),
            torch.tensor(bwd, dtype=torch.float64), torch.tensor(p2p, dtype=torch.float64),
            torch.tensor([0.0 if a else p for p, a in zip(p2p, asy)], dtype=torch.float64))
        for k in range(len(p2p)):
            f = [[fwd[s][c][k] for c in range(vp)] for s in range(pp)]
            b = [[bwd[s][c][k] for c in range(vp)] for s in range(pp)]
            if vp == 1:
                want = jb.fold_1f1b(pp, mbc, [x[0] for x in f], [x[0] for x in b], p2p[k],
                                    asy[k])
            else:
                want = jb.fold_interleaved(pp, vp, mbc, group, f, b, p2p[k], asy[k])
            case = (pp, vp, mbc, group, k)
            assert out[pp, k].item() == want[0], case
            assert out[:pp, k].tolist() == want[1], case


def test_the_op_table_waits_on_earlier_ops_only():
    """Each op's dependency slot was written by an earlier op, and every
    slot is written once: the flat orders are topological."""
    for pp, vp, mbc, group in [(2, 1, 7, 0), (8, 1, 64, 0), (4, 2, 8, 4), (3, 4, 12, 6)]:
        ops = tb.fold_table(pp, vp, mbc, group)
        written = set()
        for code, row, slot, dep in ops.tolist():
            assert dep == -1 or dep in written, (pp, vp, mbc, group)
            assert slot not in written
            assert row == (slot % (pp * vp * mbc)) // mbc
            assert code & 0xFF == row // vp
            written.add(slot)
        assert len(written) == 2 * pp * vp * mbc


def test_fold_wrapper_raises_a_kernel_error_for_bad_inputs():
    ops = torch.from_numpy(tb.fold_table(2, 1, 4, 0))
    x = torch.zeros(2, 1, 3, dtype=torch.float64)
    v = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(K.KernelError):
        K.fold_schedule(ops, x, x, v, v.float())
    with pytest.raises(K.KernelError):
        K.fold_schedule(ops[:-1], x, x, v, v)
    with pytest.raises(K.KernelError):
        K.fold_schedule(ops, x, x[:, :, :2], v, v)


def _pair(model, system, world, **spec):
    """The same family on both sides: the JAX package's strategy, model
    and system, and the port's (each side's default ``sdp_backend``)."""
    out = []
    for get_st, get_m, get_sys, mod in (
            (jax_strategy, jax_model, jax_system, jb),
            (get_strategy_config, get_model_config, get_system_config, tb)):
        st = get_st("tp1_pp1_dp8_mbs1")
        st.world_size = world
        for k, v in spec.items():
            setattr(st, k, v)
        st.__post_init__()
        out.append((st, get_m(model), get_sys(system), mod))
    return out


def _jit_batch(n):
    splits = [(1, 8), (2, 4), (4, 2), (8, 1)]
    return ([splits[i % 4][0] for i in range(n)], [splits[i % 4][1] for i in range(n)],
            [i % 3 for i in range(n)])


def _assert_scores_equal(want, got, what):
    assert want is not None and got is not None, what
    for key in SCORE_KEYS:
        assert np.array_equal(want[key], got[key]), (what, key)


# the JAX package's TestJitBackend families: (model, system, world, spec,
# candidates, cost_margin)
JIT_FAMILIES = {
    "full-block tp2 pp2": ("llama2-tiny", "tpu_v5e_256", 8,
                           dict(tp_size=2, pp_size=2, enable_recompute=True,
                                recompute_granularity="full_block", recompute_layer_num=1),
                           64, None),
    "pp2 above the auto threshold": ("llama2-tiny", "tpu_v5e_256", 8, dict(pp_size=2),
                                     2 * tb.JIT_GROUP_MIN, None),
    # a 13 GiB margin leaves the larger micro-batches unfolded (inf)
    "blocking p2p with a margin": ("llama2-tiny", "tpu_v5e_256", 8,
                                   dict(pp_size=2, pp_comm_async=False), 32, 13.0),
}


@pytest.mark.parametrize("family", list(JIT_FAMILIES))
@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_scorer_plain_folds_match_the_jax_packages_numpy_fold(family, backend):
    model, system, world, spec, n, margin = JIT_FAMILIES[family]
    (jst, jm, jsys, _), (tst, tm, tsys, _) = _pair(model, system, world, **spec)
    mbs, mbc, nrc = _jit_batch(n)
    want = jb.BatchedScorer(jm, jsys, backend="numpy").kernel_for(jst).score(
        mbs, mbc, nrc=nrc, cost_margin=margin, backend="numpy")
    got = tb.BatchedScorer(tm, tsys, backend=backend, device="cpu").kernel_for(tst).score(
        mbs, mbc, nrc=nrc, cost_margin=margin, backend=backend, device="cpu")
    _assert_scores_equal(want, got, family)
    if margin is not None:  # candidates past the margin take no fold
        finite = np.isfinite(got["iter_time"])
        assert finite.any() and not finite.all()


# the JAX package's VPP families (tests/test_batched.py:484-490)
VPP_FAMILIES = [dict(pp_size=2, interleaving_size=2), dict(pp_size=2, interleaving_size=4),
                dict(pp_size=4, tp_size=2, interleaving_size=2),
                dict(pp_size=2, interleaving_size=2, pp_comm_async=False)]


@pytest.mark.parametrize("spec", VPP_FAMILIES, ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                                      s.items()))
def test_scorer_plain_interleaved_folds_match_the_numpy_fold(spec):
    (jst, jm, jsys, _), (tst, tm, tsys, _) = _pair("llama3-8b", "tpu_v5p_256", 16, **spec)
    g = tst.vpp_group_size
    assert g == jst.vpp_group_size
    mbc = [g, 2 * g, 4 * g, 2 * g, 8 * g]
    mbs = [1] * len(mbc)
    want = jb.BatchedScorer(jm, jsys, backend="numpy").kernel_for(jst).score(
        mbs, mbc, backend="numpy")
    got = tb.BatchedScorer(tm, tsys, backend="cuda", device="cpu").kernel_for(tst).score(
        mbs, mbc, backend="cuda", device="cpu")
    _assert_scores_equal(want, got, spec)


@pytest.mark.parametrize("seq", [4096, 4000])
def test_cuda_sdp_families_score_as_the_jax_packages_pallas_ones(seq):
    """The flash-attention families: the port's ``sdp_backend="cuda"``
    against the JAX package's ``"pallas"`` (``tests/test_torch_perf.py``'s
    map). At seq 4096 both gates take the shape and the scores (the
    kernel's dispatch against the numpy fold) are equal bit for bit; at
    seq 4000 both gates refuse it, the family is invalid on both sides
    and the port's scalar path rejects it too."""
    from simumax_tpu_torch.search.searcher import evaluate_strategy

    flash = dict(pp_size=2, use_flash_sdp=True, use_math_sdp=False, seq_len=seq)
    (jst, jm, jsys, _), (tst, tm, tsys, _) = _pair("llama3-8b", "tpu_v5p_256", 8, **flash)
    jst.sdp_backend, tst.sdp_backend = "pallas", "cuda"
    jst.__post_init__()
    tst.__post_init__()
    mbs, mbc = [1, 2, 1, 4], [4, 2, 8, 1]
    want = jb.BatchedScorer(jm, jsys, backend="numpy").kernel_for(jst).score(
        mbs, mbc, backend="numpy")
    got = tb.BatchedScorer(tm, tsys, backend="cuda", device="cpu").kernel_for(tst).score(
        mbs, mbc, backend="cuda", device="cpu")
    if seq % 64 == 0:
        _assert_scores_equal(want, got, seq)
    else:
        assert want is None and got is None
        assert evaluate_strategy(tst, tm, tsys) is None


def test_fold_batch_folds_cells_of_one_shape_together():
    """A FoldBatch with the kernel's dispatch puts every candidate of a
    shape in one group, folds it with the plain version on the CPU and
    gives the numpy fold's scores."""
    (_, _, _, _), (tst, tm, tsys, _) = _pair("llama2-tiny", "tpu_v5e_256", 8, pp_size=2)
    scorer = tb.BatchedScorer(tm, tsys, backend="cuda", device="cpu")
    kern = scorer.kernel_for(tst)
    fb = tb.FoldBatch()
    thunks = [kern.score([1], [m], fold_batch=fb) for m in (4, 4, 8)]
    calls = []
    orig = K.fold_schedule

    def counted(ops, *args):
        calls.append(ops.shape[0])
        return orig(ops, *args)

    K.fold_schedule = counted
    try:
        fb.run("cuda", "cpu")
    finally:
        K.fold_schedule = orig
    assert fb.jit_dispatched == {(2, 1, 4, 0): 2, (2, 1, 8, 0): 1}
    assert sorted(calls) == [2 * 2 * 4, 2 * 2 * 8]
    for thunk, m in zip(thunks, (4, 4, 8)):
        want = kern.score([1], [m], backend="numpy")
        _assert_scores_equal(want, thunk(), m)


def test_scorer_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    m, sys_ = get_model_config("llama2-tiny"), get_system_config("tpu_v5e_256")
    for backend in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="no card"):
            tb.BatchedScorer(m, sys_, backend=backend)
    tb.BatchedScorer(m, sys_, backend="numpy")
    tb.BatchedScorer(m, sys_, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        tb.BatchedScorer(m, sys_, backend="jax", device="cpu")
