"""The level order of the search's pipeline-schedule fold
(``search/batched.py``: ``fold_levels``) and the plain version of its
CUDA kernel walking it (``torchref/kernels.py``:
``fold_schedule_plain``), held against the JAX package's numpy folds.

For each shape, 1F1B (vp 1) over pp 1-8 and the interleaved schedule
over pp 1-8 and vp 2-4, mbc from 1 to 64: ``fold_levels`` is a
permutation of ``fold_table`` with offsets that cover it; every op waits
only on ops of earlier levels and follows its stage's previous op in an
earlier level; a level holds at most one op a stage; and the plain walk
of the level-ordered table, with each level's ops in forward, reversed
and shuffled order, equals ``fold_1f1b`` / ``fold_interleaved`` of the
JAX package on seeded random times.

Tolerance: none. The plain walk and the numpy fold make the same float64
additions and comparisons on the same values, so every end and total is
equal with ``np.array_equal``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from simumax_tpu.search import batched as jb  # noqa: E402
from simumax_tpu_torch.search import batched as tb  # noqa: E402
from simumax_tpu_torch.torchref import kernels as K  # noqa: E402

SHAPES = (
    [(pp, 1, mbc, 0) for pp in range(1, 9) for mbc in (1, 3, 8, 64)]
    + [(pp, vp, pp * g * m, pp * g) for pp in (1, 2, 3, 4, 8) for vp in (2, 3, 4)
       for g, m in ((1, 1), (2, 2)) if pp * g * m <= 64]
    + [(2, 4, 64, 2), (4, 2, 64, 4), (8, 4, 64, 8)]
)
N = 3  # candidates a shape


def _levelled(pp, vp, mbc, group):
    flat = tb.fold_table(pp, vp, mbc, group)
    table, offsets = tb.fold_levels(flat)
    return flat, table, offsets


def _level_of(table, offsets):
    return np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))


@pytest.mark.parametrize("pp,vp,mbc,group", SHAPES)
def test_levels_are_a_permutation_with_covering_offsets(pp, vp, mbc, group):
    flat, table, offsets = _levelled(pp, vp, mbc, group)
    assert table.dtype == np.int32 and table.shape == flat.shape
    stripped = table.copy()
    stripped[:, 0] &= (1 << tb.LEVEL_SHIFT) - 1
    assert sorted(map(tuple, stripped.tolist())) == sorted(map(tuple, flat.tolist()))
    assert offsets[0] == 0 and offsets[-1] == len(flat)
    assert (np.diff(offsets) > 0).all()
    level = _level_of(table, offsets)
    assert tb.LEVEL_SHIFT == K._LEVEL_SHIFT  # the kernel's wrapper reads the same bits
    assert np.array_equal(table[:, 0] >> tb.LEVEL_SHIFT, offsets[level + 1])


@pytest.mark.parametrize("pp,vp,mbc,group", SHAPES)
def test_every_op_depends_only_on_earlier_levels(pp, vp, mbc, group):
    flat, table, offsets = _levelled(pp, vp, mbc, group)
    level = _level_of(table, offsets)
    by_slot = {int(slot): int(lev) for slot, lev in zip(table[:, 2], level)}
    for (code, _row, _slot, dep), lev in zip(table.tolist(), level.tolist()):
        assert dep == -1 or by_slot[dep] < lev
    # each stage's ops in the flat order lie in increasing levels
    last = {}
    for code, _row, slot, _dep in flat.tolist():
        s = code & 0xFF
        assert last.get(s, -1) < by_slot[slot]
        last[s] = by_slot[slot]
    stages = table[:, 0] & 0xFF
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        assert len(np.unique(stages[lo:hi])) == hi - lo <= pp


def _reorder(table, offsets, how, rng):
    """The table with each level's ops in another order."""
    out = table.copy()
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        idx = np.arange(lo, hi)
        if how == "reversed":
            idx = idx[::-1]
        elif how == "shuffled":
            idx = rng.permutation(idx)
        out[lo:hi] = table[idx]
    return out


@pytest.mark.parametrize("how", ["forward", "reversed", "shuffled"])
@pytest.mark.parametrize("pp,vp,mbc,group", SHAPES)
def test_levelled_plain_walk_is_the_numpy_fold_bit_for_bit(pp, vp, mbc, group, how):
    _flat, table, offsets = _levelled(pp, vp, mbc, group)
    rng = np.random.default_rng(pp * 1000 + vp * 100 + mbc)
    fwd, bwd = rng.uniform(0.01, 5.0, (2, pp, vp, N))
    p2p = rng.uniform(0.0, 2.0, N)
    asy = rng.random(N) < 0.5
    blocking = np.where(asy, 0.0, p2p)
    ops = torch.from_numpy(_reorder(table, offsets, how, rng))
    out = K.fold_schedule(ops, *(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (fwd, bwd, p2p, blocking))).numpy()
    for k in range(N):
        if vp == 1:
            total, ends = jb.fold_1f1b(pp, mbc, list(fwd[:, 0, k]), list(bwd[:, 0, k]),
                                       float(p2p[k]), bool(asy[k]))
        else:
            total, ends = jb.fold_interleaved(pp, vp, mbc, group, fwd[:, :, k].tolist(),
                                              bwd[:, :, k].tolist(), float(p2p[k]),
                                              bool(asy[k]))
        assert np.array_equal(out[:pp, k], np.array(ends)), (k, how)
        assert np.array_equal(out[pp, k], total), (k, how)


def test_the_plain_walk_refuses_a_table_out_of_level_order():
    """The flat table carries no level offsets; a level with a stage
    twice is not a level either."""
    flat = tb.fold_table(2, 1, 4, 0)
    x = torch.zeros(2, 1, 1, dtype=torch.float64)
    v = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(K.KernelError, match="level-ordered"):
        K.fold_schedule(torch.from_numpy(flat), x, x, v, v)
    table, offsets = tb.fold_levels(flat)
    lo, hi = next((lo, hi) for lo, hi in zip(offsets[:-1], offsets[1:]) if hi - lo == 2)
    bad = table.copy()
    bad[lo + 1, 0] = (bad[lo + 1, 0] & ~0xFF) | (bad[lo, 0] & 0xFF)
    with pytest.raises(K.KernelError, match="level-ordered"):
        K.fold_schedule(torch.from_numpy(bad), x, x, v, v)


def test_fold_layout_keeps_what_fits_in_shared_memory():
    """Up to four candidates a block with the table and their state in
    shared memory; the state, then the table, in global memory where a
    block cannot hold them."""
    assert K.fold_layout(512, 8, 1) == (4, True, True, 512 * 16 + 4 * 8 * (16 + 8 + 512))
    cands, table, state, nbytes = K.fold_layout(8192, 2, 1)
    assert (table, state) == (True, True) and cands == 1 and nbytes <= K._REPLAY_SMEM_MAX
    assert K.fold_layout(16384, 2, 1)[1:3] == (False, True)
    assert K.fold_layout(32768, 2, 1)[:3] == (4, False, False)
