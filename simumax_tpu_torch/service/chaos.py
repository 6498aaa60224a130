"""Deterministic chaos harness for the planner fleet (L20).

The fault model taught the *simulated* cluster to answer "what does a failure
cost?" from declarative fault scenarios (``configs/faults/*.json``).
This module applies the same discipline to the serving plane itself:
a **chaos scenario** is a JSON document of scheduled injections —
SIGKILL/SIGSTOP of node processes, connection drops and delays at the
router's socket layer, store-file corruption — and the bench
(the JAX package's ``bench_service.py --siege --chaos SCENARIO``) replays it against a
live fleet while checking invariants as oracles: no admitted request
is lost or answered wrong, the ring converges to the surviving
membership within the failure detector's probe bound, re-replication
restores owner coverage, and overload p99 stays bounded.

Everything here is deterministic: injection
*times* are literal ``at_s`` offsets from the scenario document,
injection *choices* (which entries to corrupt, which sends to drop)
come from seeded ``random.Random`` streams — the same scenario and
seed injects the same faults at the same relative times in every run,
which is what makes a chaos failure reproducible serially.

The network-layer injections cross process boundaries via one
environment variable (``SIMUMAX_CHAOS_NET``): the bench sets it before
forking fleet nodes, ``attach_fleet`` calls
:func:`maybe_install_net_chaos`, and each node's router then drops or
delays a seeded subset of its forward sends. Production serving never
pays for any of this — the hook is a no-op unless the variable is set.

Copy of the JAX package's ``service/chaos.py`` with its import paths
changed. This module starts no process: the bench that forks fleet
nodes is the JAX package's. The variable is read in each node process
at :func:`~simumax_tpu_torch.service.node.attach_fleet`, so it reaches
a node started as a fresh interpreter (spawned, or started before CUDA
is touched) as it reaches a forked one; no node inherits a CUDA
context.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from simumax_tpu_torch.core.errors import ConfigError
from simumax_tpu_torch.observe.telemetry import get_registry

SCHEMA = "simumax-service-chaos-v1"

#: the injection kinds a scenario may schedule. ``stop``/``cont``
#: freeze and thaw a node with SIGSTOP/SIGCONT (a wedged-not-dead
#: peer: accepts connections, answers nothing — the per-hop read
#: deadline's reason to exist); ``kill`` is SIGKILL (no graceful
#: anything); ``start`` respawns a previously killed node on the same
#: port and store shard (the rejoin path); ``corrupt`` flips bytes in
#: a node's store shard (the quarantine/recovery path).
EVENT_KINDS = ("kill", "stop", "cont", "start", "corrupt")

#: environment variable carrying router-socket-layer chaos to forked
#: fleet nodes: "drop_every=N,delay_every=M,delay_ms=D,seed=S"
NET_ENV = "SIMUMAX_CHAOS_NET"

_ENTRY_SUFFIX = ".entry"


class ChaosScenario:
    """One parsed, validated chaos scenario document."""

    def __init__(self, doc: dict, name: str = "<inline>"):
        if doc.get("schema") != SCHEMA:
            raise ConfigError(
                f"chaos scenario {name}: schema "
                f"{doc.get('schema')!r} != {SCHEMA!r}")
        self.name = name
        self.seed = int(doc.get("seed") or 0)
        #: failure-detector cadence the fleet under test runs with
        self.probe_s = float(doc.get("probe_s") or 0.25)
        self.net = dict(doc.get("net") or {})
        self.events: List[dict] = []
        for i, ev in enumerate(doc.get("events") or ()):
            kind = ev.get("kind")
            if kind not in EVENT_KINDS:
                raise ConfigError(
                    f"chaos scenario {name}: event {i} kind "
                    f"{kind!r} not in {EVENT_KINDS}")
            if not isinstance(ev.get("at_s"), (int, float)):
                raise ConfigError(
                    f"chaos scenario {name}: event {i} needs a "
                    f"numeric at_s offset")
            if not isinstance(ev.get("node"), int):
                raise ConfigError(
                    f"chaos scenario {name}: event {i} needs an "
                    f"integer node index")
            self.events.append(dict(ev))
        self.events.sort(key=lambda e: (e["at_s"],
                                        EVENT_KINDS.index(e["kind"]),
                                        e["node"]))

    @property
    def killed_nodes(self) -> List[int]:
        """Node indices a ``kill`` event targets (the convergence and
        rejoin oracles watch these)."""
        return sorted({e["node"] for e in self.events
                       if e["kind"] == "kill"})

    @property
    def corrupt_events(self) -> List[dict]:
        return [e for e in self.events if e["kind"] == "corrupt"]

    def net_env(self) -> Optional[str]:
        """The ``SIMUMAX_CHAOS_NET`` value of this scenario's network
        clause, or None when it injects nothing."""
        drop = int(self.net.get("drop_every") or 0)
        delay = int(self.net.get("delay_every") or 0)
        if not drop and not delay:
            return None
        return (f"drop_every={drop},delay_every={delay},"
                f"delay_ms={int(self.net.get('delay_ms') or 0)},"
                f"seed={self.seed}")


def load_scenario(spec: str) -> ChaosScenario:
    """Load a scenario from a JSON path, or by bare name from
    ``configs/faults/`` (the same resolution idiom the simulated
    fault scenarios use)."""
    path = spec
    if not os.path.exists(path):
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        base = spec if spec.endswith(".json") else spec + ".json"
        cand = os.path.join(here, "configs", "faults", base)
        if os.path.exists(cand):
            path = cand
        else:
            raise ConfigError(
                f"chaos scenario {spec!r}: no such file, and no "
                f"configs/faults/{base}")
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return ChaosScenario(doc, name=os.path.basename(path))


# -- store corruption -------------------------------------------------------
def corrupt_store_entries(root: str, count: int, seed: int,
                          registry=None) -> List[str]:
    """Flip one payload byte in ``count`` seeded-chosen entries under
    ``root`` — the bit-rot / torn-write injection the quarantine
    sweep must catch. File choice and flip offset both come from one
    ``random.Random(seed)`` stream over the *sorted* entry list, so
    the same store contents corrupt identically every run."""
    rng = random.Random(seed)
    entries: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        if ".quarantine" in dirnames:
            dirnames.remove(".quarantine")
        for fn in filenames:
            if fn.endswith(_ENTRY_SUFFIX):
                entries.append(os.path.join(dirpath, fn))
    entries.sort()
    if not entries:
        return []
    picks = []
    for _ in range(min(count, len(entries))):
        path = entries.pop(rng.randrange(len(entries)))
        picks.append(path)
    reg = registry or get_registry()
    corrupted = []
    for path in picks:
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                # flip within the payload tail: headers are one line,
                # so any offset in the last quarter is payload bytes
                # and breaks the digest check
                off = size - 1 - rng.randrange(max(1, size // 4))
                f.seek(max(0, off))
                byte = f.read(1)
                f.seek(max(0, off))
                f.write(bytes([byte[0] ^ 0xFF]) if byte else b"\xff")
        except OSError:
            continue
        corrupted.append(path)
        reg.counter("chaos_injections_total", kind="corrupt").inc()
    return corrupted


# -- router socket-layer chaos ----------------------------------------------
class NetChaos:
    """Seeded drop/delay schedule over a router's forward sends.

    ``drop_every=N`` fails every Nth send with a synthetic
    ``ConnectionResetError`` *before* any bytes move (the
    connection-level error class the router already retries);
    ``delay_every=M`` sleeps ``delay_ms`` before the Mth sends
    (tail-latency injection — what hedging and per-hop deadlines
    race against). Counts are process-local and deterministic:
    same request order, same injections."""

    def __init__(self, drop_every: int = 0, delay_every: int = 0,
                 delay_ms: int = 0, seed: int = 0, registry=None):
        self.drop_every = int(drop_every)
        self.delay_every = int(delay_every)
        self.delay_s = int(delay_ms) / 1000.0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._sends = 0
        self.registry = registry or get_registry()
        self.counters = {"drops": 0, "delays": 0}

    def before_send(self):
        """Called per forward send; raises to drop, sleeps to delay."""
        with self._lock:
            self._sends += 1
            n = self._sends
            drop = self.drop_every and n % self.drop_every == 0
            delay = (not drop and self.delay_every
                     and n % self.delay_every == 0)
            if drop:
                self.counters["drops"] += 1
            if delay:
                self.counters["delays"] += 1
        if drop:
            self.registry.counter("chaos_injections_total",
                                  kind="drop").inc()
            raise ConnectionResetError("chaos: injected drop")
        if delay:
            self.registry.counter("chaos_injections_total",
                                  kind="delay").inc()
            time.sleep(self.delay_s)

    def install(self, router):
        """Wrap ``router._send`` so every forward leg consults this
        schedule first. The wrapped send raises the injected drop as
        an ordinary connection error — the router's own retry and
        hedging machinery handles it, which is the point."""
        inner = router._send

        def chaotic_send(node, endpoint, raw_body, headers,
                         hop_timeout):
            try:
                self.before_send()
            except ConnectionResetError:
                return None  # dropped before any bytes moved
            return inner(node, endpoint, raw_body, headers,
                         hop_timeout)

        router._send = chaotic_send
        return self


def parse_net_env(value: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for part in value.split(","):
        k, sep, v = part.partition("=")
        if not sep:
            continue
        try:
            out[k.strip()] = int(v)
        except ValueError:
            continue
    return out


def maybe_install_net_chaos(router) -> Optional[NetChaos]:
    """Install router-socket chaos when ``SIMUMAX_CHAOS_NET`` is set
    (the bench exports it before forking fleet nodes); no-op — and
    zero overhead — otherwise."""
    value = os.environ.get(NET_ENV)
    if not value:
        return None
    cfg = parse_net_env(value)
    return NetChaos(
        drop_every=cfg.get("drop_every", 0),
        delay_every=cfg.get("delay_every", 0),
        delay_ms=cfg.get("delay_ms", 0),
        seed=cfg.get("seed", 0),
    ).install(router)


# -- the injector -----------------------------------------------------------
class ChaosInjector:
    """Replays a scenario's process-level events against live fleet
    processes. The bench owns the processes; this class owns the
    schedule: :meth:`start` arms a thread that fires each event at
    its ``at_s`` offset, or tests drive :meth:`fire` synchronously.

    ``pid_of(node_idx)`` must return the node's current pid (it
    changes across a kill+start cycle), ``respawn(node_idx)``
    restarts a killed node on its original port and store shard, and
    ``store_root(node_idx)`` names the shard directory ``corrupt``
    events target."""

    def __init__(self, scenario: ChaosScenario,
                 pid_of: Callable[[int], Optional[int]],
                 respawn: Callable[[int], None],
                 store_root: Callable[[int], str],
                 registry=None):
        self.scenario = scenario
        self.pid_of = pid_of
        self.respawn = respawn
        self.store_root = store_root
        self.registry = registry or get_registry()
        self.fired: List[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- event application -------------------------------------------------
    def fire(self, event: dict) -> dict:
        """Apply one event now; returns the forensics record."""
        kind, node = event["kind"], event["node"]
        record = dict(event)
        try:
            if kind in ("kill", "stop", "cont"):
                pid = self.pid_of(node)
                if pid is None:
                    record["skipped"] = "no such process"
                else:
                    sig = {"kill": signal.SIGKILL,
                           "stop": signal.SIGSTOP,
                           "cont": signal.SIGCONT}[kind]
                    os.kill(pid, sig)
                    record["pid"] = pid
                    self.registry.counter("chaos_injections_total",
                                          kind=kind).inc()
            elif kind == "start":
                self.respawn(node)
                self.registry.counter("chaos_injections_total",
                                      kind="start").inc()
            elif kind == "corrupt":
                record["corrupted"] = corrupt_store_entries(
                    self.store_root(node),
                    int(event.get("entries") or 1),
                    # per-event stream: seeded by scenario seed and
                    # the event's schedule position, so two corrupt
                    # events never reuse one stream
                    self.scenario.seed * 1000 + int(event["at_s"] * 10),
                    registry=self.registry)
        except (OSError, ProcessLookupError) as exc:
            record["error"] = str(exc)
        with self._lock:
            self.fired.append(record)
        return record

    # -- scheduled replay --------------------------------------------------
    def start(self):
        """Fire every event at its offset from now, on a thread."""
        t0 = time.monotonic()

        def loop():
            for event in self.scenario.events:
                delay = event["at_s"] - (time.monotonic() - t0)
                if delay > 0 and self._stop.wait(delay):
                    return
                if self._stop.is_set():
                    return
                self.fire(event)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="chaos-injector")
        self._thread.start()

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout)

    def close(self):
        self._stop.set()

    def report(self) -> List[dict]:
        with self._lock:
            return list(self.fired)
