"""Span recorder: the measured half of the planned-vs-measured ledger.

The CARLA paper evaluates entirely through an analytic model (cycles, DRAM
words, PUF per layer — ``core.cost_model``).  This module records what the
PyTorch/CUDA side *actually does* on the host: every instrumented layer
boundary opens a span with the mode the controller picked, the operand
shapes and the bytes the arrays touch, and — for ``carla_conv`` — the
analytic ``LayerCost`` the ASIC model predicts for the same layer.  A span
times the host from the call to its return: nothing inside a span waits
for the device, so spans can run inside a timed window or beside the
profiler, and the device's time comes only from the device trace.  Call
sites work out their ledger attributes after the span has closed, so a
span's self time is dispatch work, not bookkeeping.

The spans of one CNN forward, from the root down (``cnn.forward`` is the
request's identifier: every span of a forward has it as ancestor)::

    cnn.forward                      models/cnn.py: resnet50_apply, vgg16_apply
      cnn.pool, cnn.head             the PyTorch ops the model runs itself
      carla_conv                     core/carla.py
        carla.plan                   the decision: route, stationarity,
                                     the tuning lookup (core/autotune.py)
        kernels.conv2d | kernels.conv1x1 | kernels.gemm   (kernels/ops.py)
          kernels.load               _build.load, a library's first use
                                     (also kept in _build.loads untraced)
          kernels.launch             the foreign call and its error check

A ``kernels.*`` span's self time (its duration less its children's) is the
preparation: the launch plan of the decision ``carla.plan`` made, operand
checks, workspace, output allocation and the device context.  The paper's
controller choice and analytic cost are worked out after ``carla_conv``
closes, for its attributes.

Design constraints:

  * **Zero overhead when disabled** (the default).  Instrumented call sites
    gate on ``trace.enabled()`` — a single module-attribute read — and call
    the function directly when tracing is off.  No span objects, no
    context managers, no clock reads on the disabled path.
  * **Nesting** — spans opened while another span is active become children
    (thread-local stack), so a ``carla_conv`` span contains the
    ``kernels.conv2d`` span it dispatched to.
  * **One clock with the device trace** — spans keep ``perf_counter``
    seconds; each ``capture()`` takes an ``Anchor`` (``time.time_ns()``
    beside ``perf_counter_ns()``) as it opens, and ``Anchor.epoch_ns`` puts
    a span on the Unix-epoch nanoseconds that ``torch.profiler``'s events
    carry.
  * **JSON round-trip** — ``to_json``/``from_json`` preserve the span forest
    exactly, so reports can be produced offline from an exported trace.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Iterator, NamedTuple


class Anchor(NamedTuple):
    """One reading of the wall clock and ``perf_counter`` side by side."""

    wall_ns: int
    perf_ns: int

    @classmethod
    def now(cls) -> "Anchor":
        return cls(time.time_ns(), time.perf_counter_ns())

    def epoch_ns(self, perf_s: float) -> int:
        """A ``perf_counter`` reading (seconds) in Unix-epoch nanoseconds."""
        return self.wall_ns + round(perf_s * 1e9) - self.perf_ns


@dataclass(slots=True)
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

    def span(self, name: str, **attrs):
        """Open a span; nested calls attach as children.

        When the tracer is disabled this yields ``None`` without touching the
        clock — but hot paths should gate on ``enabled()`` and skip the call
        entirely.  An object with ``__enter__``/``__exit__`` rather than a
        generator: each span is host time added to the spans around it.
        """
        if not self.enabled:
            return _CLOSED
        return _Open(self, Span(name=name, attrs=attrs,
                                tid=threading.get_ident()))

    def attach(self, sp: Span) -> None:
        """Record a span timed by its caller, as a child of the open span
        (or a root); nothing when tracing is off."""
        if not self.enabled:
            return
        stack = self._stack()
        (stack[-1].children if stack else self.spans).append(sp)

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


class _Open:
    """An open span: pushed on its thread's stack on entry, timed and
    attached to its parent (or the roots) on exit."""

    __slots__ = ("tracer", "sp")

    def __init__(self, tracer: Tracer, sp: Span) -> None:
        self.tracer, self.sp = tracer, sp

    def __enter__(self) -> Span:
        self.tracer._stack().append(self.sp)
        self.sp.start_s = time.perf_counter()
        return self.sp

    def __exit__(self, *exc) -> None:
        sp = self.sp
        sp.duration_s = time.perf_counter() - sp.start_s
        stack = self.tracer._stack()
        stack.pop()
        if stack:
            stack[-1].children.append(sp)
        else:
            self.tracer.spans.append(sp)


_CLOSED = nullcontext()
tracer = Tracer()


def enabled() -> bool:
    """The hot-path gate: one global read, nothing else."""
    return tracer.enabled


def enable() -> None:
    tracer.enabled = True


def disable() -> None:
    tracer.enabled = False


def span(name: str, **attrs):
    return tracer.span(name, **attrs)


class Capture:
    """Holds the root spans recorded inside one ``capture()`` block.

    While the block is open, ``spans`` aliases the tracer's live list; on
    exit it keeps the captured roots even though the tracer's previous
    state (enabled flag AND previously collected spans) is restored.
    ``anchor`` is the clock reading taken as the block opened: it puts the
    captured spans on the device trace's time base.
    """

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.anchor = Anchor.now()

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
