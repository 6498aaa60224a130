"""Planning-service layer: so far only the persistent content-addressed
result store (``store.py``), which the strategy search keys its sweep
cells with. The planner facade, the server and the fleet modules of the
JAX package's ``service/`` are a later slice of the port."""

from simumax_tpu_torch.service.store import (
    ContentStore,
    canonical,
    canonical_bytes,
    code_version,
    content_key,
    default_cache_dir,
)

__all__ = [
    "ContentStore",
    "canonical",
    "canonical_bytes",
    "code_version",
    "content_key",
    "default_cache_dir",
]
