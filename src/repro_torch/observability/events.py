"""Structured JSONL event log for the serving/training control planes.

Spans record *how long* things took; events record *what happened*: a
request admitted to slot 3, a checkpoint written at step 400, a straggler
step, an elastic re-mesh.  Each event is one JSON line::

    {"ts": <unix seconds>, "kind": "<domain>.<verb>", ...free-form fields}

``kind`` is dot-namespaced by subsystem; the kinds the port emits:

  serve.prefill / serve.complete
  scheduler.admit / scheduler.complete / scheduler.evict
  train.step / fault.straggler / fault.checkpoint / fault.preempt
  elastic.remesh
  data.worker_error / data.closed

A copy of ``repro.observability.events``.  Design mirrors ``trace``: one
module-level sink, disabled by default, and instrumented call sites gate on
``events.enabled()`` (a single attribute read) so the hot loops pay nothing
when logging is off.  ``install(path)`` opens the sink (line-buffered
append; a lock keeps lines atomic across threads); ``uninstall()`` closes
it.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Iterator

_SCHEMA_KEYS = ("ts", "kind")


class EventLog:
    """Append-only JSONL sink; thread-safe, flushed per line."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._lock = threading.Lock()
        self.emitted = 0

    def emit(self, kind: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "kind": kind, **fields}
        line = json.dumps(rec, default=str)
        with self._lock:
            self._f.write(line + "\n")
            self.emitted += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


_log: EventLog | None = None


def enabled() -> bool:
    """The hot-path gate: one module-attribute read."""
    return _log is not None


def install(path: str) -> EventLog:
    """Open (or switch) the global event log; returns the sink."""
    global _log
    if _log is not None:
        _log.close()
    _log = EventLog(path)
    return _log


def uninstall() -> None:
    global _log
    if _log is not None:
        _log.close()
        _log = None


def get() -> EventLog | None:
    return _log


def emit(kind: str, **fields: Any) -> None:
    """Emit to the global log; no-op (after one attribute read) when off."""
    log = _log
    if log is not None:
        log.emit(kind, **fields)


def read(path: str) -> Iterator[dict]:
    """Parse a JSONL event file back into dicts (validates the envelope)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            for k in _SCHEMA_KEYS:
                if k not in rec:
                    raise ValueError(f"event missing {k!r}: {rec}")
            yield rec
