"""The most memory the caching allocator held for tensors over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start), in GiB."""

LAYER = "device: one H100"
UNIT = "GiB"
MOVES = "tokens_per_s"


def read(record):
    if not record["peak_alloc_bytes"]:
        return None
    return record["peak_alloc_bytes"] / 2 ** 30
