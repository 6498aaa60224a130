"""The port's strategy search (``search/searcher.py``, ``executor.py``,
``batched.py``; ``service/store.py``) held against the JAX package's on
its TPU system configs.

Cases: the dense standard grid (Llama3-8B on ``tpu_v5p_256``, world 64,
gbs 64, tp {1,2,4,8} x pp {1,2,4}) with ``engine="scalar"``; the dense
wide grid (the same with pp {1,2,4,8} x ZeRO {0,1,2,3}) with
``engine="batched"`` in grid and guided mode; the guided Mixtral-8x7B
sweep (``ep4_pp2_dp4_mbs1``, tp x pp x ep {1,2,4,8} x ZeRO {0..3}), in
guided mode, where the sweep-wide fold batch sends shape groups to the
kernel's dispatch, and in grid mode. The port's batched engine runs
with ``device="cpu"``: the fold kernel's plain version wherever the
card would run the kernel. The JAX package's batched engine runs its
numpy fold (its ``jax_available`` patched to False: its jitted folds
need ``jax.experimental.enable_x64``, which this jax lacks, and the JAX
package pins its numpy fold to them bit for bit). Then, in the port
alone: ``jobs=2`` against serial; a sweep through a content store; the
refusal of a batched sweep without a card; and a failing fold kernel,
which must stop the sweep instead of becoming must-evaluate screens or
``status=error`` rows.

Tolerance: none. Rows are compared as JSON (sorted keys), and the audit
CSVs as text.
"""

import copy
import json

import pytest

torch = pytest.importorskip("torch")

from simumax_tpu.core import config as jc  # noqa: E402
from simumax_tpu.core.records import Diagnostics as JaxDiagnostics  # noqa: E402
from simumax_tpu.search import batched as jb  # noqa: E402
from simumax_tpu.search import search_best_parallel_strategy as jax_search  # noqa: E402
from simumax_tpu_torch.core import config as tc  # noqa: E402
from simumax_tpu_torch.core.records import Diagnostics  # noqa: E402
from simumax_tpu_torch.search import StrategySearcher, search_best_parallel_strategy  # noqa: E402
from simumax_tpu_torch.search import executor as te  # noqa: E402
from simumax_tpu_torch.service import ContentStore  # noqa: E402
from simumax_tpu_torch.torchref import kernels as K  # noqa: E402

SYSTEM = "tpu_v5p_256"
SWEEPS = {
    "dense-standard": ("llama3-8b", "tp1_pp1_dp8_mbs1",
                       dict(tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4), zero_list=(1,))),
    "dense-wide": ("llama3-8b", "tp1_pp1_dp8_mbs1",
                   dict(tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4, 8), zero_list=(0, 1, 2, 3))),
    "mixtral": ("mixtral-8x7b", "ep4_pp2_dp4_mbs1",
                dict(tp_list=(1, 2, 4, 8), pp_list=(1, 2, 4, 8), ep_list=(1, 2, 4, 8),
                     zero_list=(0, 1, 2, 3))),
}


@pytest.fixture
def jax_numpy_fold(monkeypatch):
    monkeypatch.setattr(jb, "jax_available", lambda: False)


def _inputs(cfg, sweep):
    model, strategy, lists = SWEEPS[sweep]
    base = cfg.get_strategy_config(strategy)
    base.world_size = 64
    base.__post_init__()
    return base, cfg.get_model_config(model), cfg.get_system_config(SYSTEM), lists


def _port(sweep, diag=None, **kw):
    base, model, system, lists = _inputs(tc, sweep)
    diag = diag if diag is not None else Diagnostics()
    return search_best_parallel_strategy(base, model, system, 64, topk=5, diagnostics=diag,
                                         **lists, **kw), diag


def _jax(sweep, **kw):
    base, model, system, lists = _inputs(jc, sweep)
    diag = JaxDiagnostics()
    return jax_search(base, model, system, 64, topk=5, diagnostics=diag, **lists, **kw), diag


def _json(rows):
    return json.dumps(rows, sort_keys=True)


CASES = [("dense-standard", "scalar", "grid"), ("dense-wide", "batched", "grid"),
         ("dense-wide", "batched", "guided"), ("mixtral", "batched", "guided"),
         ("mixtral", "batched", "grid")]


@pytest.mark.parametrize("sweep,engine,mode", CASES, ids=["-".join(c) for c in CASES])
def test_port_search_returns_the_jax_packages_rows(jax_numpy_fold, tmp_path, sweep, engine,
                                                   mode):
    kw = dict(engine=engine, search_mode=mode)
    want, jdiag = _jax(sweep, csv_path=str(tmp_path / "jax.csv"), **kw)
    port_kw = dict(kw, device="cpu") if engine == "batched" else kw
    got, diag = _port(sweep, csv_path=str(tmp_path / "port.csv"), **port_kw)
    assert len(got) == 5
    assert _json(got) == _json(want)
    assert diag.counters == jdiag.counters
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    assert not diag.counters.get("sweep_cells_quarantined")
    if mode == "guided":
        scorer = te._batched_scorer(*_inputs(tc, sweep)[1:3], "cpu")
        groups = scorer.last_screen_jit
        if sweep == "mixtral":
            # the guided Mixtral screen folds 11 shape groups of 36-48
            # cells through the kernel's dispatch
            assert len(groups) == 11 and min(groups.values()) >= 36, groups
        else:
            assert not groups  # 12 cells a shape: under FOLD_BATCH_JIT_MIN


def test_port_pool_sweep_equals_the_serial_sweep():
    serial, sdiag = _port("dense-wide", engine="batched", device="cpu")
    pooled, pdiag = _port("dense-wide", engine="batched", device="cpu", jobs=2)
    assert _json(pooled) == _json(serial)
    assert pdiag.counters["sweep_cells_batched"] == sdiag.counters["sweep_cells_batched"]
    scalar, _ = _port("dense-standard", engine="scalar")
    scalar_pooled, _ = _port("dense-standard", engine="scalar", jobs=2)
    assert _json(scalar_pooled) == _json(scalar)


def test_port_sweep_through_a_content_store_serves_its_cells(tmp_path):
    store = ContentStore(str(tmp_path / "store"))
    fresh, _ = _port("dense-standard", engine="batched", device="cpu", store=store)
    served, diag = _port("dense-standard", engine="batched", device="cpu", store=store)
    assert _json(served) == _json(fresh)
    assert diag.counters["sweep_cells_cached"] == diag.counters["sweep_cells_total"]
    stats = store.stats()
    assert stats["counters"]["hits"] >= diag.counters["sweep_cells_cached"]
    assert stats["namespaces"]["sweep"]["entries"] == diag.counters["sweep_cells_total"]


def test_batched_search_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    base, model, system, lists = _inputs(tc, "dense-standard")
    with pytest.raises(RuntimeError, match="no card"):
        search_best_parallel_strategy(base, model, system, 64, engine="batched", **lists)
    with pytest.raises(RuntimeError, match="no card"):
        StrategySearcher(model, system, base).search(64, engine="batched", **lists)
    rows = StrategySearcher(model, system, base).search(64, engine="scalar", **lists)
    assert rows and all(r["fits"] for r in rows)


def _failing_fold(*args, **kwargs):
    raise K.KernelError("fold_schedule: made to fail")


@pytest.mark.parametrize("mode,jobs", [("guided", 1), ("grid", 1), ("grid", 2)])
def test_a_failing_fold_kernel_stops_the_search(monkeypatch, mode, jobs):
    """The kernel's error goes through the guided screen's must-evaluate
    rule (the default backend folds the screen's shape groups) and the
    executor's quarantine (a scorer with ``backend="cuda"``: the grid's
    inline groups are under the default's threshold), serial and pooled
    (the pool's forked workers inherit both patches), and stops the
    sweep."""
    from simumax_tpu_torch.search.batched import BatchedScorer

    monkeypatch.setattr(K, "fold_schedule", _failing_fold)
    monkeypatch.setattr(te, "_SCORERS", {})
    if mode == "grid":
        monkeypatch.setattr(te, "_batched_scorer", lambda model, system, device="cuda":
                            BatchedScorer(model, system, backend="cuda", device=device))
    base, model, system, lists = _inputs(tc, "mixtral")
    with pytest.raises(K.KernelError, match="made to fail"):
        search_best_parallel_strategy(copy.deepcopy(base), model, system, 64, topk=5,
                                      engine="batched", search_mode=mode, device="cpu",
                                      jobs=jobs, **lists)


def test_other_screen_errors_keep_the_copied_must_evaluate_rule(monkeypatch):
    """An error of the shared fold that is not the kernel's still turns
    every screened cell into must-evaluate: the sweep returns the grid's
    rows."""
    from simumax_tpu_torch.search import batched as tb

    def failing_run(self, backend="auto", device="cuda"):
        raise ValueError("not the kernel")

    grid, _ = _port("dense-wide", engine="batched", device="cpu")
    monkeypatch.setattr(tb.FoldBatch, "run", failing_run)
    guided, diag = _port("dense-wide", engine="batched", device="cpu", search_mode="guided")
    assert _json(guided) == _json(grid)
    assert not diag.counters.get("sweep_cells_guided_skipped")
