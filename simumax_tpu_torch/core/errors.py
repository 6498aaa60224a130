"""Typed failure taxonomy (L0).

Every anticipated failure mode of the simulator gets its own exception
class carrying structured context, so the layers above (strategy search,
calibration, CLI) can react per-kind — quarantine a candidate, retry a
microbenchmark, print a one-line actionable message — instead of pattern
matching on tracebacks. ``to_dict()`` makes every failure
machine-readable for the diagnostics JSON report (see
``core/records.py::Diagnostics`` and ``docs/diagnostics.md``).

Hierarchy::

    SimuMaxError
    ├── ConfigError (ValueError)        infeasible / inconsistent configs
    │   ├── FeasibilityError            candidate cannot run (OOM, divisibility)
    │   └── UnknownConfigError (KeyError)  name not in the config registry
    ├── CalibrationError                microbenchmark failed / implausible
    ├── SimulationError (RuntimeError)  engine invariant violations
    │   └── DeadlockError               (defined in simulator/engine.py)
    └── CandidateTimeoutError           per-candidate sweep deadline hit

    CardRequiredError (RuntimeError)    the port's: no CUDA card for work
                                        that runs on one

The JAX package's taxonomy, with one addition of the PyTorch/CUDA
port: :class:`CardRequiredError`, outside the ``SimuMaxError`` family
(it is no fact about a configuration or a simulation: the machine
lacks the card the caller asked for).

This module must stay import-light (stdlib only): it sits below
``core/config.py`` and is imported by every layer.
"""

from __future__ import annotations

from typing import Any, Dict


def _json_safe(value: Any):
    """Best-effort conversion of context values to JSON-serializable
    primitives (tuples -> lists, objects -> repr)."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_json_safe(v) for v in value]
    return repr(value)


class SimuMaxError(Exception):
    """Base of the taxonomy.

    ``context`` holds structured keyword facts about the failure —
    conventional keys: ``model`` / ``strategy`` / ``system`` (the config
    triple), ``phase`` (configure | estimate | search | calibrate |
    simulate), ``candidate`` (sweep cell key), ``op_key`` / ``shape_key``
    (efficiency-table coordinates).
    """

    def __init__(self, message: str = "", **context: Any):
        super().__init__(message)
        self.message = message
        self.context: Dict[str, Any] = dict(context)

    def __str__(self) -> str:  # KeyError mixins would repr() the message
        return self.message

    def with_context(self, **context: Any) -> "SimuMaxError":
        """Attach facts discovered above the raise site (e.g. the sweep
        loop knows the candidate key, the raise site does not)."""
        for k, v in context.items():
            self.context.setdefault(k, v)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "error": type(self).__name__,
            "message": self.message,
            "context": _json_safe(self.context),
        }


class ConfigError(SimuMaxError, ValueError):
    """An infeasible / inconsistent config combination.

    Raised by the config ``sanity_check``s and the cross-config checks so
    that strategy search can reject a candidate without also swallowing
    internal invariant failures (which stay ``AssertionError`` /
    ``SimulationError``). Subclasses ``ValueError`` for backward
    compatibility with pre-taxonomy callers."""


class FeasibilityError(ConfigError):
    """The candidate is structurally valid but cannot run: it does not
    fit in HBM, or a divisibility requirement (gbs % dp, layers % stages)
    rules it out."""


class UnknownConfigError(ConfigError, KeyError):
    """A config name is not in the registry. Carries ``kind`` (models |
    strategy | system) and ``name`` so the CLI can list alternatives."""

    def __init__(self, kind: str, name: str, available=(), **context: Any):
        msg = (
            f"unknown {kind} config {name!r}; "
            f"available: {', '.join(sorted(available)) or '(none found)'}"
        )
        super().__init__(msg, kind=kind, name=name,
                         available=sorted(available), **context)
        self.kind = kind
        self.name = name
        self.available = sorted(available)


class CalibrationError(SimuMaxError):
    """A calibration microbenchmark failed after retries, or produced an
    implausible efficiency (outside ``(0, 1.05]`` / non-finite), or a
    calibrated table's provenance does not match the system it is being
    loaded into."""


class SimulationError(SimuMaxError, RuntimeError):
    """A discrete-event engine invariant was violated (mismatched
    rendezvous, duplicate send, unknown request, deadlock). Subclasses
    ``RuntimeError`` for backward compatibility."""


class CandidateTimeoutError(SimuMaxError):
    """A sweep candidate exceeded its per-candidate deadline and was
    interrupted (see ``search/searcher.py`` fault isolation)."""


class CardRequiredError(RuntimeError):
    """Work that runs on the CUDA card was asked for where there is
    none: the machine has no card, or a card-only measurement was given
    the CPU. Nothing carries on on the CPU in its place; the command
    line prints it as one line."""


__all__ = [
    "CardRequiredError",
    "SimuMaxError",
    "ConfigError",
    "FeasibilityError",
    "UnknownConfigError",
    "CalibrationError",
    "SimulationError",
    "CandidateTimeoutError",
]
