"""Chrome/Perfetto ``trace_event`` exporter for the span forest.

Converts the in-process trace (``trace.Span``) into the Trace Event Format
that chrome://tracing and https://ui.perfetto.dev load directly:

  * every span becomes a complete event (``ph: "X"``) with microsecond
    ``ts``/``dur`` on its recording thread's track (``pid``/``tid``);
  * every ``carla_conv`` span additionally feeds **counter tracks**
    (``ph: "C"``): the analytic model's prediction (ASIC ms, DRAM MB, PUF)
    next to the measured wall ms, so predicted-vs-measured is a plot, not
    a table;
  * a **flow arrow** (``ph: "s"`` / ``ph: "f"``) connects each
    ``carla_conv`` dispatch to the kernel span it routed to, which makes
    the controller's mode choice followable in the UI.

Timestamps are re-based to the earliest span in the forest (span clocks are
``perf_counter`` readings — only differences are meaningful).  A copy of
``repro.observability.export`` over the port's spans.
"""
from __future__ import annotations

import json
from typing import Any

from .report import CARLA_SPAN
from .trace import Span

PROCESS_NAME = "repro_torch.carla"
DEFAULT_PID = 1

# Counter tracks emitted per carla_conv dispatch: (track name, attr -> value).
_COUNTER_TRACKS = (
    ("carla predicted vs measured (ms)",
     lambda s: {"analytic_ms": s.attrs.get("analytic_time_ms", 0.0),
                "measured_ms": s.duration_s * 1e3}),
    ("carla analytic cycles",
     lambda s: {"cycles": s.attrs.get("analytic_cycles", 0)}),
    ("carla DRAM (MB)",
     lambda s: {"analytic_mb": s.attrs.get("analytic_dram_bytes", 0) / 1e6,
                "measured_mb": s.attrs.get("bytes_touched", 0) / 1e6}),
    ("carla utilization (PUF)",
     lambda s: {"analytic_puf": s.attrs.get("analytic_puf", 0.0)}),
)


def _jsonable(v: Any) -> Any:
    """Trace-viewer args must be JSON; stringify anything exotic."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def to_chrome_trace(spans: list[Span], *, pid: int = DEFAULT_PID) -> dict:
    """Span forest -> Trace Event Format dict (``{"traceEvents": [...]}``)."""
    all_spans = [s for root in spans for s in root.walk()]
    t0 = min((s.start_s for s in all_spans), default=0.0)
    # raw thread idents -> small stable track ids, in first-seen order
    tid_map: dict[int, int] = {}
    for s in all_spans:
        tid_map.setdefault(s.tid, len(tid_map) + 1)

    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": PROCESS_NAME},
    }]
    for raw, small in tid_map.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": small,
            "args": {"name": f"dispatch-{small}" if len(tid_map) > 1
                     else "dispatch"},
        })

    flow_id = 0
    for root in spans:
        for s in root.walk():
            ts = (s.start_s - t0) * 1e6
            tid = tid_map[s.tid]
            events.append({
                "name": s.name, "cat": "span", "ph": "X",
                "ts": ts, "dur": s.duration_s * 1e6,
                "pid": pid, "tid": tid,
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            })
            if s.name != CARLA_SPAN:
                continue
            for track, fn in _COUNTER_TRACKS:
                events.append({
                    "name": track, "ph": "C", "ts": ts, "pid": pid,
                    "args": {k: _jsonable(v) for k, v in fn(s).items()},
                })
            for child in s.children:
                flow_id += 1
                cts = (child.start_s - t0) * 1e6
                events.append({
                    "name": "dispatch", "cat": "carla", "ph": "s",
                    "id": flow_id, "ts": ts, "pid": pid, "tid": tid,
                })
                events.append({
                    "name": "dispatch", "cat": "carla", "ph": "f",
                    "bp": "e", "id": flow_id, "ts": cts, "pid": pid,
                    "tid": tid_map[child.tid],
                })

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"exporter": "repro_torch.observability.export"}}


def export_chrome_trace(spans: list[Span], path: str, *,
                        pid: int = DEFAULT_PID) -> None:
    """Write a Perfetto-loadable JSON trace file."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, pid=pid), f)
