"""Span recorder: the measured half of the planned-vs-measured ledger.

The CARLA paper evaluates entirely through an analytic model (cycles, DRAM
words, PUF per layer — ``core.cost_model``).  This module records what the
PyTorch/CUDA side *actually does* so the two can be reconciled: every
instrumented dispatch (``kernels.ops``, ``core.carla.carla_conv``) opens a
span that captures the mode the controller picked, the operand shapes, the
wall time (callers sync with ``torch.cuda.synchronize`` inside the span), the
bytes the arrays touch, and — for ``carla_conv`` — the analytic ``LayerCost``
the ASIC model predicts for the same layer.

Design constraints:

  * **Zero overhead when disabled** (the default).  Instrumented call sites
    gate on ``trace.enabled()`` — a single module-attribute read — and call
    the jitted function directly when tracing is off.  No span objects, no
    context managers, no clock reads on the disabled path.
  * **Nesting** — spans opened while another span is active become children
    (thread-local stack), so a ``carla_conv`` span contains the
    ``kernels.conv2d`` span it dispatched to.
  * **JSON round-trip** — ``to_json``/``from_json`` preserve the span forest
    exactly, so reports can be produced offline from an exported trace.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator


@dataclass
class Span:
    """One recorded region: name, wall time, free-form attrs, children."""

    name: str
    start_s: float = 0.0
    duration_s: float = 0.0
    attrs: dict[str, Any] = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)
    tid: int = 0                 # OS thread ident at record time

    # ----------------------------- aggregation -------------------------------
    def walk(self) -> Iterator["Span"]:
        """This span and all descendants, pre-order."""
        yield self
        for c in self.children:
            yield from c.walk()

    def total(self, key: str, default: float = 0.0) -> float:
        """Sum a numeric attr over this span and every descendant."""
        return sum(s.attrs.get(key, default) for s in self.walk())

    def self_time_s(self) -> float:
        """Duration not covered by direct children."""
        return self.duration_s - sum(c.duration_s for c in self.children)

    # ------------------------------ serialization ----------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "start_s": self.start_s,
            "duration_s": self.duration_s,
            "attrs": self.attrs,
            "children": [c.to_dict() for c in self.children],
            "tid": self.tid,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            name=d["name"],
            start_s=d["start_s"],
            duration_s=d["duration_s"],
            attrs=dict(d["attrs"]),
            children=[cls.from_dict(c) for c in d["children"]],
            tid=d.get("tid", 0),    # pre-exporter traces lack the field
        )


class Tracer:
    """Collects a forest of spans.  One global instance (``trace.tracer``)."""

    def __init__(self) -> None:
        self.enabled = False
        self.spans: list[Span] = []          # root spans, in completion order
        self._local = threading.local()

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        """Open a span; nested calls attach as children.

        When the tracer is disabled this yields ``None`` without touching the
        clock — but hot paths should gate on ``enabled()`` and skip the call
        entirely.
        """
        if not self.enabled:
            yield None
            return
        sp = Span(name=name, attrs=attrs, tid=threading.get_ident())
        stack = self._stack()
        stack.append(sp)
        t0 = time.perf_counter()
        sp.start_s = t0
        try:
            yield sp
        finally:
            sp.duration_s = time.perf_counter() - t0
            stack.pop()
            if stack:
                stack[-1].children.append(sp)
            else:
                self.spans.append(sp)

    # ------------------------------ management -------------------------------
    def clear(self) -> None:
        self.spans = []
        self._local = threading.local()

    def find(self, name: str) -> list[Span]:
        """All spans (any depth) with the given name."""
        return [s for root in self.spans for s in root.walk()
                if s.name == name]

    # ------------------------------ export -----------------------------------
    def to_json(self, indent: int | None = None) -> str:
        return json.dumps([s.to_dict() for s in self.spans], indent=indent)

    def from_json(self, payload: str) -> list[Span]:
        """Parse an exported trace back into a span forest (does not mutate
        the tracer's own state)."""
        return [Span.from_dict(d) for d in json.loads(payload)]

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))


tracer = Tracer()


def enabled() -> bool:
    """The hot-path gate: one global read, nothing else."""
    return tracer.enabled


def enable() -> None:
    tracer.enabled = True


def disable() -> None:
    tracer.enabled = False


def clear() -> None:
    tracer.clear()


def span(name: str, **attrs):
    return tracer.span(name, **attrs)


class Capture:
    """Holds the root spans recorded inside one ``capture()`` block.

    While the block is open, ``spans`` aliases the tracer's live list; on
    exit it keeps the captured roots even though the tracer's previous
    state (enabled flag AND previously collected spans) is restored.
    """

    def __init__(self) -> None:
        self.spans: list[Span] = []

    def find(self, name: str) -> list[Span]:
        return [s for root in self.spans for s in root.walk()
                if s.name == name]


@contextmanager
def capture():
    """Enable tracing for a block, restoring the previous state after.

    Yields a :class:`Capture` holding only the spans recorded inside the
    block::

        with trace.capture() as tr:
            carla_conv(x, w)
        rows = report.reconcile(tr.spans)

    The tracer's prior state — the enabled flag *and* any root spans
    collected before the block — is saved and restored, so sequential or
    nested captures never destroy earlier results.
    """
    prev_enabled = tracer.enabled
    prev_spans = tracer.spans
    cap = Capture()
    tracer.spans = cap.spans        # collect into the capture, live
    tracer.enabled = True
    try:
        yield cap
    finally:
        cap.spans = tracer.spans    # in case someone reassigned the list
        tracer.spans = prev_spans
        tracer.enabled = prev_enabled
