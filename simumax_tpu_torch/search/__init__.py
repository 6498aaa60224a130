"""Strategy search: so far only the sweep-cell pruning (``prune.py``),
which ``PerfLLM.rebatched_iter_time`` uses. The searcher, the executor
and the batched pipeline folds are a later slice of the port."""
