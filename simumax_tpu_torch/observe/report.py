"""Shared structured reporter: the one place library code is allowed to
write user-facing progress/report lines (``tests/test_no_bare_print.py``
enforces this — ``print(`` is forbidden in ``simumax_tpu_torch/`` outside this
module and the CLI).

Two output modes, switched by the CLI's ``--log-json`` flag:

* **human** (default): each call prints exactly its ``msg`` string —
  byte-identical to the bare ``print(...)`` calls it replaced, so
  existing scripts/tests that parse stdout keep working;
* **json** (``--log-json``): one JSON object per line with ``ts``
  (epoch seconds), ``level``, ``run_id``, ``msg``, plus any structured
  fields the call site attached — machine-ingestable run logs that
  merge/attribute across processes via the run identity. Lines emitted
  inside an active telemetry trace (a served HTTP request, a
  ``--trace-requests`` command) additionally carry ``trace_id`` /
  ``span_id``, so run logs cross-reference span trees and the
  ``X-SimuMax-Trace`` response header.

``--log-level`` filters: a call below the threshold emits nothing in
either mode. ``debug`` lines only appear with ``--log-level debug``.

Copy of the JAX package's ``observe/report.py``. The telemetry spans are
not ported yet, so JSON lines carry no ``trace_id`` / ``span_id``.
"""

from __future__ import annotations

import json
import sys
import time
import uuid
from typing import Any, Optional, TextIO

from simumax_tpu_torch.core.errors import ConfigError

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


class Reporter:
    """Leveled line reporter with human/JSON dual output.

    ``stream=None`` resolves ``sys.stdout`` at emit time (so pytest's
    capsys and CLI redirection both see the output)."""

    def __init__(self, level: str = "info", json_lines: bool = False,
                 run_id: str = "", stream: Optional[TextIO] = None):
        self.configure(level=level, json_lines=json_lines, run_id=run_id,
                       stream=stream)

    def configure(self, level: Optional[str] = None,
                  json_lines: Optional[bool] = None,
                  run_id: Optional[str] = None,
                  stream: Optional[TextIO] = None) -> "Reporter":
        if level is not None:
            if level not in LEVELS:
                raise ConfigError(
                    f"unknown log level {level!r}: expected one of "
                    f"{sorted(LEVELS)}"
                )
            self.level = level
            self.threshold = LEVELS[level]
        if json_lines is not None:
            self.json_lines = json_lines
        if run_id is not None:
            self.run_id = run_id or uuid.uuid4().hex[:12]
        if stream is not None:
            self.stream = stream
        elif not hasattr(self, "stream"):
            self.stream = None
        return self

    # -- emission ----------------------------------------------------------
    def log(self, level: str, msg: str, **fields: Any):
        if LEVELS[level] < self.threshold:
            return
        out = self.stream if self.stream is not None else sys.stdout
        if self.json_lines:
            record = {
                "ts": time.time(),
                "level": level,
                "run_id": self.run_id,
                "msg": msg,
            }
            record.update(fields)
            out.write(json.dumps(record, default=str) + "\n")
        else:
            # byte-identical to the print(...) calls this replaced
            out.write(msg + "\n")

    def debug(self, msg: str, **fields: Any):
        self.log("debug", msg, **fields)

    def info(self, msg: str, **fields: Any):
        self.log("info", msg, **fields)

    def warning(self, msg: str, **fields: Any):
        self.log("warning", msg, **fields)

    def error(self, msg: str, **fields: Any):
        self.log("error", msg, **fields)


#: process-wide reporter; the CLI reconfigures it from --log-level /
#: --log-json, library code fetches it via get_reporter()
_REPORTER = Reporter()


def get_reporter() -> Reporter:
    return _REPORTER


def configure_reporter(level: Optional[str] = None,
                       json_lines: Optional[bool] = None,
                       run_id: Optional[str] = None,
                       stream: Optional[TextIO] = None) -> Reporter:
    """Reconfigure the process-wide reporter (the CLI boundary calls
    this once, before any command body runs)."""
    return _REPORTER.configure(level=level, json_lines=json_lines,
                               run_id=run_id, stream=stream)
