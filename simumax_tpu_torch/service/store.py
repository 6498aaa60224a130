"""Persistent on-disk content-addressed store (L9).

The perf/search/simulate entry points are pure functions of the fully
resolved (model config, strategy config, system config incl. calibration
provenance, package code-version) tuple, which makes them perfectly
memoizable across processes. This module provides the storage half of
that contract:

* **keys** are SHA-256 hashes of a canonical JSON rendering of the
  query identity (:func:`content_key`): dict key order, tuples vs
  lists, and set ordering are normalized away, so byte-identical
  configs expressed differently map to the same key, while any change
  to a config field, a calibration table, the provenance stamp, or the
  package ``__version__`` changes the key (invalidation = key change;
  stale entries age out via LRU eviction, they are never served);
* **entries** are single files, written atomically (temp file +
  ``os.replace``) into 256-way sharded directories
  (``<root>/<namespace>/<key[:2]>/<key>.entry``). Each file carries a
  one-line JSON header (format, payload digest, creation time,
  code-version) followed by the payload bytes — canonical JSON for
  result payloads, pickle for binary artifacts such as the batched
  block-kind profile cache;
* **integrity**: every read re-hashes the payload bytes against the
  header digest; a mismatching (torn, bit-rotted, hand-edited) entry
  is quarantined (moved into ``<root>/.quarantine/``, counted, never
  deleted outright) and reported as a miss, never served.
  the JAX package's ``cache verify`` command runs the same check over the whole
  store and ``--drop`` routes through the same quarantine path;
  :meth:`ContentStore.recover` is the crash-recovery sweep a fleet
  node runs at start so a torn shard never reaches the serving path;
* **eviction**: the store is size-bounded; when a put pushes the total
  payload bytes over ``max_bytes`` the least-recently-used entries
  (file mtime, bumped on every hit) are deleted until the store is
  back under budget.

The default root is ``~/.cache/simumax-tpu`` (``SIMUMAX_TPU_CACHE_DIR``
overrides; CLI commands take ``--cache-dir``). One-shot CLI calls, the
Streamlit app, and the ``serve`` server all share it — a result
computed anywhere is a hit everywhere.

Copy of the JAX package's ``service/store.py`` with its import paths
changed: :func:`code_version` reads ``simumax_tpu_torch.version``, and
the ``store_*`` metrics join the port's telemetry catalogue. The port's
searcher keys its sweep cells with :func:`content_key` and takes a
:class:`ContentStore` for its ``store=`` argument; the rest of the
service layer is not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from simumax_tpu_torch.core.errors import ConfigError

#: known namespaces (directories under the root). Nothing enforces the
#: set — it documents the layout and seeds `cache stats` rendering.
NAMESPACES = ("estimate", "explain", "sweep", "profiles", "des",
              "fleet")

#: default size budget: plenty for years of sweep cells, small enough
#: to never matter on a dev machine
DEFAULT_MAX_BYTES = 512 * 1024 * 1024

_ENTRY_SUFFIX = ".entry"

#: corrupt entries are moved here (under the store root) instead of
#: deleted: forensics can inspect the torn bytes, the fleet node can
#: count what recovery removed and re-pull exactly those keys, and
#: ``_walk`` prunes the directory so quarantined entries are invisible
#: to every read/manifest/eviction path.
_QUARANTINE_DIR = ".quarantine"


def code_version() -> str:
    """The package version stamped into every cache key — resolved at
    call time (not import time) so a version bump invalidates without
    a process restart and tests can monkeypatch it."""
    import simumax_tpu_torch.version

    return simumax_tpu_torch.version.__version__


def default_cache_dir() -> str:
    env = os.environ.get("SIMUMAX_TPU_CACHE_DIR")
    if env:
        return env
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"),
        "simumax-tpu",
    )


def canonical(obj: Any) -> Any:
    """Normalize a payload to its canonical JSON-safe form: dicts with
    string keys (sorted at dump time), lists for every sequence, sorted
    lists for sets, ``default=str`` semantics for anything else. The
    single normalization both the key hash and the stored/returned
    payloads go through — so a cache hit returns bit-identical bytes to
    the evaluation that populated it."""
    if isinstance(obj, dict):
        return {str(k): canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [canonical(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(canonical(v) for v in obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "to_dict"):
        return canonical(obj.to_dict())
    return str(obj)


def canonical_bytes(obj: Any) -> bytes:
    return json.dumps(
        canonical(obj), sort_keys=True, separators=(",", ":"),
        default=str,
    ).encode("utf-8")


def content_key(identity: Any) -> str:
    """SHA-256 hex key of a canonicalized identity payload."""
    return hashlib.sha256(canonical_bytes(identity)).hexdigest()


def normalized(obj: Any) -> Any:
    """Full canonical round-trip (dump + load): the exact object a
    store hit returns — key-sorted dicts, lists, JSON scalar types.
    Fresh evaluations pass through this too, so hit and miss payloads
    are indistinguishable down to dict iteration order."""
    return json.loads(canonical_bytes(obj).decode("utf-8"))


class ContentStore:
    """Sharded, integrity-checked, LRU-bounded entry store.

    Thread-safe (one lock around the counters and eviction scan; the
    file operations themselves are atomic) and safe to share between
    processes — concurrent writers of the same key atomically replace
    each other with identical content."""

    def __init__(self, root: Optional[str] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 registry=None):
        from simumax_tpu_torch.observe.telemetry import get_registry

        self.root = os.path.abspath(root or default_cache_dir())
        self.max_bytes = int(max_bytes)
        #: metrics registry the per-instance counters mirror into
        #: (``store_ops_total{op=...}`` — the scrapeable view; the
        #: dict below stays the per-instance ``stats()`` source)
        self.registry = registry or get_registry()
        self._lock = threading.Lock()
        #: separate lock for the eviction/size bookkeeping: an eviction
        #: pass walks and deletes files, and must never stall the
        #: counter updates every concurrent get/put makes under _lock
        self._evict_lock = threading.Lock()
        #: approximate store size, maintained incrementally so the hot
        #: put path never walks the tree; None = not yet measured (the
        #: first put pays one scan), re-anchored exactly whenever an
        #: eviction pass scans anyway. Guarded by _evict_lock.
        self._approx_bytes: Optional[int] = None
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "puts": 0,
            "evictions": 0, "corrupt_dropped": 0,
            "quarantined": 0,
        }

    # -- paths -------------------------------------------------------------
    def _path(self, namespace: str, key: str) -> str:
        return os.path.join(
            self.root, namespace, key[:2], key + _ENTRY_SUFFIX
        )

    def _count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        self.registry.counter("store_ops_total", op=name).inc(n)

    # -- entry I/O ---------------------------------------------------------
    @staticmethod
    def _read_header(path: str) -> dict:
        """Parse just the one-line JSON header of an entry — the
        metadata path (``cache ls``) must not read and re-hash every
        payload in the store (that is ``verify``'s job)."""
        with open(path, "rb") as f:
            line = f.readline()
        if not line.endswith(b"\n"):
            # intra-module miss-path signal: get()/verify() catch
            # ValueError and count the entry corrupt, never re-raise
            raise ValueError("missing header line")  # noqa: SIM004
        return json.loads(line.decode("utf-8"))

    @staticmethod
    def _read_entry(path: str):
        """Parse one entry file into (header, payload_bytes); raises
        ``ValueError`` on any structural or digest mismatch."""
        with open(path, "rb") as f:
            blob = f.read()
        nl = blob.find(b"\n")
        if nl < 0:
            # same intra-module miss-path signal as _read_header
            raise ValueError("missing header line")  # noqa: SIM004
        header = json.loads(blob[:nl].decode("utf-8"))
        body = blob[nl + 1:]
        digest = hashlib.sha256(body).hexdigest()
        if digest != header.get("sha256"):
            # corrupt-entry signal for get(): caught, counted, dropped
            raise ValueError(  # noqa: SIM004
                f"payload digest {digest[:12]} != header "
                f"{str(header.get('sha256'))[:12]}"
            )
        return header, body

    @staticmethod
    def _decode(header: dict, body: bytes):
        if header.get("fmt") == "pickle":
            return pickle.loads(body)
        return json.loads(body.decode("utf-8"))

    def get(self, namespace: str, key: str, default=None):
        """Integrity-checked lookup; a corrupt entry is dropped (and
        counted) rather than served."""
        path = self._path(namespace, key)
        try:
            header, body = self._read_entry(path)
        except FileNotFoundError:
            self._count("misses")
            return default
        except (OSError, ValueError, json.JSONDecodeError,
                pickle.UnpicklingError, EOFError) as exc:
            self._drop_corrupt(path, exc)
            self._count("misses")
            return default
        try:
            payload = self._decode(header, body)
        except Exception as exc:  # torn pickle, bad JSON after digest?
            self._drop_corrupt(path, exc)
            self._count("misses")
            return default
        self._count("hits")
        try:
            os.utime(path, None)  # LRU recency
        except OSError:
            pass
        return payload

    def get_bytes(self, namespace: str, key: str) -> Optional[bytes]:
        """Integrity-checked lookup returning the raw canonical payload
        bytes of a JSON entry — for consumers (the HTTP server) whose
        response serialization IS the stored serialization, so a hit
        skips the parse + re-dump of a large payload entirely."""
        path = self._path(namespace, key)
        try:
            header, body = self._read_entry(path)
        except FileNotFoundError:
            self._count("misses")
            return None
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            self._drop_corrupt(path, exc)
            self._count("misses")
            return None
        if header.get("fmt") != "json":
            self._count("misses")
            return None
        self._count("hits")
        try:
            os.utime(path, None)  # LRU recency
        except OSError:
            pass
        return body

    def _drop_corrupt(self, path: str, exc: Exception):
        self._count("corrupt_dropped")
        self._quarantine(path, exc)

    def _quarantine(self, path: str, exc: Exception) -> Optional[str]:
        """Move one corrupt/torn entry into ``.quarantine/<ns>/``
        (atomic rename — the entry vanishes from the serving namespace
        and its bytes survive for forensics), count it, and drop a
        sidecar ``.reason`` note. Returns the quarantine path, or None
        if the file was already gone."""
        rel = os.path.relpath(path, self.root)
        parts = rel.split(os.sep)
        ns = parts[0] if len(parts) > 1 else "_unknown"
        dest_dir = os.path.join(self.root, _QUARANTINE_DIR, ns)
        dest = os.path.join(dest_dir, os.path.basename(path))
        try:
            os.makedirs(dest_dir, exist_ok=True)
            os.replace(path, dest)
        except OSError:
            return None
        try:
            with open(dest + ".reason", "w", encoding="utf-8") as f:
                f.write(f"{type(exc).__name__}: {exc}\n")
        except OSError:
            pass
        self._count("quarantined")
        self.registry.counter("store_quarantined_total").inc()
        return dest

    def quarantined(self) -> List[dict]:
        """Forensics/recovery listing of the quarantine directory: one
        row per captured entry with the namespace and key it was
        serving under (recovered from the sharded path layout), sorted
        for determinism."""
        qroot = os.path.join(self.root, _QUARANTINE_DIR)
        out: List[dict] = []
        if not os.path.isdir(qroot):
            return out
        for dirpath, _dirnames, filenames in os.walk(qroot):
            for fn in filenames:
                if not fn.endswith(_ENTRY_SUFFIX):
                    continue
                path = os.path.join(dirpath, fn)
                reason = ""
                try:
                    with open(path + ".reason", encoding="utf-8") as f:
                        reason = f.read().strip()
                except OSError:
                    pass
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                out.append({
                    "namespace": os.path.relpath(dirpath, qroot)
                    .split(os.sep)[0],
                    "key": fn[:-len(_ENTRY_SUFFIX)],
                    "bytes": size,
                    "reason": reason,
                })
        out.sort(key=lambda e: (e["namespace"], e["key"]))
        return out

    def recover(self) -> dict:
        """Crash-recovery sweep a node runs before serving: re-hash
        every entry and quarantine anything torn or corrupt, so a
        crash mid-``os.replace`` (or plain bit rot accumulated while
        down) can never surface as a served payload. Returns the
        checked/ok counts plus the (namespace, key) rows quarantine
        removed — the fleet node re-pulls exactly those owned keys
        from its replicas."""
        checked = 0
        removed: List[dict] = []
        for path in list(self._walk()):
            checked += 1
            try:
                self._read_entry(path)
            except (OSError, ValueError, json.JSONDecodeError) as exc:
                rel = os.path.relpath(path, self.root)
                parts = rel.split(os.sep)
                fn = os.path.basename(path)
                if self._quarantine(path, exc) is not None:
                    removed.append({
                        "namespace":
                            parts[0] if len(parts) > 1 else "",
                        "key": fn[:-len(_ENTRY_SUFFIX)],
                        "error": str(exc),
                    })
        with self._evict_lock:
            self._approx_bytes = None  # re-anchor on the next put
        return {
            "checked": checked,
            "ok": checked - len(removed),
            "quarantined": removed,
        }

    def put(self, namespace: str, key: str, payload: Any,
            fmt: str = "json") -> str:
        """Atomic write-rename of one entry; returns the entry path."""
        if fmt == "pickle":
            body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        elif fmt == "json":
            body = canonical_bytes(payload)
        else:
            raise ConfigError(f"unknown entry format {fmt!r}", fmt=fmt)
        header = {
            "v": 1,
            "ns": namespace,
            "key": key,
            "fmt": fmt,
            "sha256": hashlib.sha256(body).hexdigest(),
            "size": len(body),
            # wall-clock is header metadata only — never part of the
            # key or the payload bytes a hit returns
            "created": time.time(),  # noqa: SIM003
            "code_version": code_version(),
        }
        path = self._path(namespace, key)
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(json.dumps(header, separators=(",", ":"))
                        .encode("utf-8"))
                f.write(b"\n")
                f.write(body)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self._count("puts")
        try:
            entry_size = os.path.getsize(path)
        except OSError:
            entry_size = len(body)
        self._evict_if_needed(entry_size)
        return path

    # -- maintenance -------------------------------------------------------
    def _walk(self, namespace: Optional[str] = None) -> Iterator[str]:
        roots = (
            [os.path.join(self.root, namespace)]
            if namespace else [self.root]
        )
        for r in roots:
            if not os.path.isdir(r):
                continue
            for dirpath, dirnames, filenames in os.walk(r):
                # quarantined entries are out of the store: invisible
                # to reads, manifests, stats, and eviction alike
                if _QUARANTINE_DIR in dirnames:
                    dirnames.remove(_QUARANTINE_DIR)
                for fn in filenames:
                    if fn.endswith(_ENTRY_SUFFIX):
                        yield os.path.join(dirpath, fn)

    def entries(self, namespace: Optional[str] = None) -> List[dict]:
        """Header metadata of every entry (``cache ls``): namespace,
        key, format, size, created/last-used timestamps."""
        out = []
        for path in self._walk(namespace):
            try:
                header = self._read_header(path)
                st = os.stat(path)
            except (OSError, ValueError, json.JSONDecodeError):
                continue
            out.append({
                "namespace": header.get("ns", ""),
                "key": header.get("key", ""),
                "fmt": header.get("fmt", ""),
                "bytes": header.get("size", 0),
                "created": header.get("created", 0.0),
                "last_used": st.st_mtime,
                "code_version": header.get("code_version", ""),
            })
        out.sort(key=lambda e: (e["namespace"], -e["last_used"]))
        return out

    # -- replication (service/node.py replica pull) ------------------------
    def manifest(self, namespace: Optional[str] = None) -> List[dict]:
        """Replication inventory: one row per entry with its
        ``(path, mtime, size)`` stamp — the freshness key a fleet
        replica pulls against (the JAX package's ``docs/service.md``,
        "Planner fleet").
        The path is root-relative (peers have different roots); the
        stamp changes whenever the file is replaced, so a replica that
        recorded a stamp re-pulls exactly when the owner rewrote the
        entry. Sorted by (namespace, key): deterministic across
        processes (SIM003)."""
        out = []
        for path in self._walk(namespace):
            try:
                header = self._read_header(path)
                st = os.stat(path)
            except (OSError, ValueError, json.JSONDecodeError):
                continue
            out.append({
                "namespace": header.get("ns", ""),
                "key": header.get("key", ""),
                "fmt": header.get("fmt", ""),
                "sha256": header.get("sha256", ""),
                "stamp": [os.path.relpath(path, self.root),
                          st.st_mtime, st.st_size],
            })
        out.sort(key=lambda e: (e["namespace"], e["key"]))
        return out

    def entry_sha(self, namespace: str, key: str) -> Optional[str]:
        """The payload digest of one held entry (header-only read), or
        None — the replica puller's already-have check."""
        try:
            header = self._read_header(self._path(namespace, key))
        except (OSError, ValueError, json.JSONDecodeError):
            return None
        return header.get("sha256")

    def export_entry(self, namespace: str, key: str
                     ) -> Optional[bytes]:
        """The raw entry file bytes (header line + payload) for
        replication — the receiving replica re-verifies the digest, so
        the wire format IS the disk format and a replicated entry is
        byte-identical to the original."""
        try:
            with open(self._path(namespace, key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def import_entry(self, namespace: str, key: str,
                     raw: bytes) -> bool:
        """Atomically install one replicated raw entry after verifying
        its header/digest and that it actually is (namespace, key) —
        a replica never trusts the wire. Returns False (and installs
        nothing) on any mismatch."""
        nl = raw.find(b"\n")
        if nl < 0:
            return False
        try:
            header = json.loads(raw[:nl].decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return False
        body = raw[nl + 1:]
        if (header.get("ns") != namespace or header.get("key") != key
                or header.get("sha256")
                != hashlib.sha256(body).hexdigest()):
            return False
        path = self._path(namespace, key)
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self._count("puts")
        self._evict_if_needed(len(raw))
        return True

    def stats(self) -> dict:
        """Per-namespace entry/byte totals plus the live counters."""
        namespaces: Dict[str, Dict[str, int]] = {}
        total = 0
        for path in self._walk():
            ns = os.path.relpath(path, self.root).split(os.sep)[0]
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            d = namespaces.setdefault(ns, {"entries": 0, "bytes": 0})
            d["entries"] += 1
            d["bytes"] += size
            total += size
        with self._lock:
            counters = dict(self.counters)
        return {
            "root": self.root,
            "max_bytes": self.max_bytes,
            "total_bytes": total,
            "namespaces": namespaces,
            "counters": counters,
            "quarantine_entries": len(self.quarantined()),
        }

    def verify(self, namespace: Optional[str] = None,
               drop: bool = False) -> dict:
        """Re-hash every payload against its header digest
        (``cache verify``). Returns checked/ok counts plus the corrupt
        entry paths; ``drop=True`` quarantines them (same path as a
        corrupt read and the start-time :meth:`recover` sweep — the
        bytes land in ``.quarantine/`` for forensics, never deleted
        outright)."""
        checked = 0
        corrupt: List[dict] = []
        for path in list(self._walk(namespace)):
            checked += 1
            try:
                self._read_entry(path)
            except (OSError, ValueError, json.JSONDecodeError) as exc:
                corrupt.append({"path": path, "error": str(exc)})
                if drop:
                    self._quarantine(path, exc)
        return {
            "checked": checked,
            "ok": checked - len(corrupt),
            "corrupt": corrupt,
            "dropped": drop,
        }

    def clear(self, namespace: Optional[str] = None) -> int:
        """Delete every entry (optionally of one namespace); returns
        the number removed."""
        removed = 0
        for path in list(self._walk(namespace)):
            try:
                os.remove(path)
                removed += 1
            except OSError:
                continue
        with self._evict_lock:
            self._approx_bytes = None  # re-anchor on the next put
        return removed

    def _evict_if_needed(self, added_bytes: int = 0):
        """LRU eviction down to 90% of budget once the total payload
        size exceeds ``max_bytes``. The hot put path only bumps the
        incrementally-maintained size estimate; the full tree walk
        happens once on the first put (to anchor the estimate) and
        again only when the budget is actually exceeded — an eviction
        pass re-anchors it exactly. Runs under its own lock so the
        walk/delete never blocks the counter updates of concurrent
        gets/puts."""
        with self._evict_lock:
            if self._approx_bytes is not None:
                self._approx_bytes += added_bytes
                if self._approx_bytes <= self.max_bytes:
                    return
            sized = []
            total = 0
            for path in self._walk():
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                sized.append((st.st_mtime, st.st_size, path))
                total += st.st_size
            if total <= self.max_bytes:
                self._approx_bytes = total
                return
            target = int(self.max_bytes * 0.9)
            sized.sort()  # oldest mtime (least recently used) first
            evicted = 0
            for _mtime, size, path in sized:
                if total <= target:
                    break
                try:
                    os.remove(path)
                except OSError:
                    continue
                total -= size
                evicted += 1
            self._approx_bytes = total
        if evicted:
            self._count("evictions", evicted)
