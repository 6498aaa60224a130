"""Planning-service layer: the persistent content-addressed result
store (``store.py``), the ``Planner`` facade every entry point routes
through (``planner.py``), and the JSON-over-HTTP query server
(``server.py``) with its worker pool, router, ring, warmer, fleet node
and chaos harness. Exports what the JAX package's
``service/__init__.py`` exports.

The ``docs/service.md`` the modules name (the cache-key contract,
invalidation rules, server API and eviction policy) is the JAX
package's.
"""

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
    "Planner",
    "canonical",
    "canonical_bytes",
    "code_version",
    "content_key",
    "default_cache_dir",
]


def __getattr__(name):
    # Planner pulls in perf/search; keep `import simumax_tpu_torch.service`
    # light for store-only consumers
    if name == "Planner":
        from simumax_tpu_torch.service.planner import Planner

        return Planner
    raise AttributeError(name)
