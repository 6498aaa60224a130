"""Strategy search: the sweep-cell pruning (``prune.py``), the searcher
(``searcher.py``), the serial and pooled cell executor
(``executor.py``) and the batched cost kernel (``batched.py``), whose
pipeline-schedule folds run on the card (``csrc/fold.cu``). Exports what
the JAX package's ``search/__init__.py`` exports."""

from simumax_tpu_torch.search.executor import (  # noqa: F401
    BoundedCache,
    CellOutcome,
    run_cells,
)
from simumax_tpu_torch.search.batched import (  # noqa: F401
    BatchedScorer,
    UnsupportedBatched,
)
from simumax_tpu_torch.search.prune import (  # noqa: F401
    SweepCell,
    enumerate_cells,
    memory_lower_bound,
    make_cell_strategy,
)
from simumax_tpu_torch.search.searcher import (  # noqa: F401
    StrategySearcher,
    SweepJournal,
    evaluate_strategy,
    search_best_parallel_strategy,
    search_best_selective_recompute,
    search_best_recompute_layer_num,
    search_max_micro_batch_size,
    search_micro_batch_config,
)
