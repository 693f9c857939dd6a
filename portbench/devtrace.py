"""Device activity of a stated number of forwards, from ``torch.profiler``.

Only device activity is recorded (no host events), so the profiler costs
the host little; the harness times the same forwards without it and
prints both walls.  Busy time is the union of the device intervals; the
rest of the profiled wall is idle.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

NAME_CHARS = 120


@dataclass(frozen=True)
class Profile:
    forwards: int
    wall_s: float             # the profiled forwards on the host's clock
    busy_s: float             # union of device intervals
    device_ops: int           # kernels, copies and sets on the device
    by_name: dict             # device op name -> seconds, summed
    gaps: dict                # where an idle gap falls -> seconds, summed


def _short(name: str) -> str:
    return name.split("<")[0].split("(")[0].strip()[:NAME_CHARS]


def summarize(spans: list, wall_s: float, forwards: int) -> Profile:
    """spans: (start_us, end_us, name) of every device op, any order."""
    spans = sorted(spans)
    per = len(spans) // forwards if len(spans) % forwards == 0 else 0
    busy, end, by_name, gaps = 0.0, None, {}, {}
    for i, (s, e, name) in enumerate(spans):
        if end is not None and s > end:
            if per and i % per == 0:
                where = "between forwards: logits read back, next call"
            elif per:
                where = f"before op {i % per} of {per} ({_short(name)})"
            else:
                where = f"before {_short(name)}"
            gaps[where] = gaps.get(where, 0.0) + (s - end) / 1e6
        busy += e - s if end is None else max(0.0, e - max(s, end))
        end = e if end is None else max(end, e)
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    return Profile(forwards, wall_s, busy / 1e6, len(spans), by_name, gaps)


def profile(run, forwards: int, tries: int = 3) -> Profile | None:
    """Profile ``run()``, which makes ``forwards`` forwards.  A profile
    with no device activity at all is the profiler losing its events (seen
    about once in ten), not a reading: it is taken again, up to ``tries``
    times.  Returns None if every try comes back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for _ in range(tries):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if spans:
            return summarize(spans, wall, forwards)
    return None


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device ops that took most time and the longest idle gaps, each
    in seconds summed over the profiled forwards."""
    def most(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": most(p.by_name), "idle_gaps": most(p.gaps)}
