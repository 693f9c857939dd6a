"""The program's own spans beside the device trace: where the host's
dispatch time goes, where the device idles, and each kernel route's share
of its roofline.

A ``--trace 1`` run on the card reads these after its window, its
profiled pass and the reference, through the per-layer metrics that call
``passes``.  Two more passes of the traffic's ``profiled_forwards`` run on
the cell, the program's tracing on in both and nowhere else: first with no
profiler (the host metrics read it, since the profiler's own work would
swell the host's time), then under the profiler (the route rooflines and
the idle split read it).  Their weights and images are drawn from a seed
of their own (``SEED``): a dense forward's times do not depend on the
values.

The spans are put on the profiler's clock by the capture's anchor
(``repro_torch.observability.trace.Anchor``).  Each device op is tied to
the host call that launched it by the CUDA runtime's record of that call,
which carries the op's correlation id; a call made inside a
``kernels.launch`` span matches the op to that dispatch, so no kernel is
told apart by its name.  Each gap in the device's activity is cut by the
host's innermost open span, in a profile whose device clock agrees with
its host clock (``clock_ok``; another profile is taken where it does
not).  One line on standard error
(``{"host_spans": ...}``) gives what the metrics summarise:
``idle_ms_by_host_span``, the host's self time by span, every route's
roofline and the matching's counts.

    PYTHONPATH=src python3 -m portbench.hostspans --workload <cell> \\
        --seed <n> --out PATH

writes the profiled pass as one Perfetto JSON file: the program's spans
and the device ops on one timeline.

Against a program without these spans (its recorder has no ``Anchor``)
every reader gets None, and no pass runs.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
from dataclasses import dataclass

import torch

from . import harness, spec
from .archs import tracing, work

SEED = 1_000_003               # the passes' weights and images
TRIES = 8                      # profiles taken before giving up on a clock
# A step starts on an idle device (the one before it ended in a synchronise),
# so its first kernel starts within this much of the call that launched it
# (4-30 us on an H100), unless the profiler's device clock has slipped.  A
# profile's first launch waits for the profiler itself (0.5-0.6 ms).
IDLE_LEAD_NS = 100_000
PREPARE = ("kernels.conv2d", "kernels.conv1x1", "kernels.gemm")
POOL_HEAD = ("cnn.pool", "cnn.head")
# a kernel route: the ``route`` attributes of its kernels.launch spans
ROUTES = {"conv2d": ("conv2d",),
          "conv1x1": ("mm_act_stationary", "mm_weight_stationary")}
NONE = "none"                  # no span open: between forwards


@dataclass(frozen=True)
class DeviceOp:
    start_ns: int              # Unix-epoch nanoseconds, the profiler's clock
    end_ns: int
    name: str
    launched_ns: int | None    # the host's call that launched it, if known


@dataclass
class Passes:
    forwards: int
    enqueue_ms: list           # host ms of each forward's call, spans on
    host: list                 # the cnn.forward spans of that pass
    profiled: list             # the cnn.forward spans of the profiled pass
    anchor: object             # the profiled capture's trace.Anchor
    ops: list                  # the profiled pass's DeviceOps, by start
    window_ns: tuple           # the profiled pass on the epoch clock
    clock_ok: bool = True      # device times agree with the launches'


def device_ops(events) -> list[DeviceOp]:
    """The device's ops among the profiler's events (``kineto_results``),
    each with the start of the CUDA runtime call of the same correlation
    id: the host's launch."""
    from torch.autograd import DeviceType
    calls = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith("cuda"):
            calls.setdefault(e.correlation_id(), e.start_ns())
    return sorted((DeviceOp(e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name(), calls.get(e.correlation_id()))
                   for e in events if e.device_type() == DeviceType.CUDA),
                  key=lambda o: o.start_ns)


def clock_ok(roots: list, anchor, ops: list[DeviceOp]) -> bool:
    """Whether the profile's device clock agrees with its host clock: no
    op starts before the call that launched it, and the first launch of
    each forward but the profile's first (each onto an idle device) starts
    within ``IDLE_LEAD_NS``.  On an H100 about one profile in four fails
    this, its device times off by tens of microseconds to milliseconds;
    durations and the launch records stay sound."""
    launched = sorted((op.launched_ns, op.start_ns) for op in ops
                      if op.launched_ns is not None)
    if not launched or any(start < call for call, start in launched):
        return False
    calls = [call for call, _ in launched]
    for root in roots[1:]:
        i = bisect.bisect_left(calls, _ns(root, anchor)[0])
        if i == len(calls) or launched[i][1] - calls[i] > IDLE_LEAD_NS:
            return False
    return True


def _ns(sp, anchor) -> tuple[int, int]:
    start = anchor.epoch_ns(sp.start_s)
    return start, start + round(sp.duration_s * 1e9)


def innermost(roots: list, anchor) -> list[tuple[int, int, str]]:
    """(start ns, end ns, name) of the innermost open span at each instant
    the spans cover, in order."""
    out = []

    def walk(sp):
        t, end = _ns(sp, anchor)
        for c in sorted(sp.children, key=lambda c: c.start_s):
            cs, ce = _ns(c, anchor)
            if cs > t:
                out.append((t, cs, sp.name))
            walk(c)
            t = max(t, ce)
        if end > t:
            out.append((t, end, sp.name))
    for root in roots:
        walk(root)
    return sorted(out)


def idle_by_span(ops: list[DeviceOp], segments: list, window: tuple
                 ) -> dict[str, int]:
    """Nanoseconds of the window in which no device op runs, by the host's
    innermost open span (``NONE`` outside every span)."""
    starts = [s for s, _, _ in segments]
    out: dict[str, int] = {}

    def cut(a, b):
        i = max(0, bisect.bisect_right(starts, a) - 1)
        t = a
        while t < b and i < len(segments):
            s, e, label = segments[i]
            if e <= t:
                i += 1
            elif s > t:
                out[NONE] = out.get(NONE, 0) + min(s, b) - t
                t = min(s, b)
            else:
                hi = min(e, b)
                out[label] = out.get(label, 0) + hi - t
                t, i = hi, i + 1
        if t < b:
            out[NONE] = out.get(NONE, 0) + b - t

    busy_end = window[0]
    for op in ops:
        if op.start_ns > busy_end:
            cut(busy_end, min(op.start_ns, window[1]))
        busy_end = max(busy_end, op.end_ns)
    if window[1] > busy_end:
        cut(busy_end, window[1])
    return out


def launch_spans(roots: list, anchor) -> list[tuple]:
    """(start ns, end ns, kernels.launch span, its carla_conv or None) of
    every launch, in order."""
    out = []

    def walk(sp, conv):
        if sp.name == "carla_conv":
            conv = sp
        if sp.name == "kernels.launch":
            out.append((*_ns(sp, anchor), sp, conv))
        for c in sp.children:
            walk(c, conv)
    for root in roots:
        walk(root, None)
    return sorted(out, key=lambda t: t[0])


def matches(roots: list, anchor, ops: list[DeviceOp]) -> list[tuple]:
    """(device op, kernels.launch span, carla_conv span) of every op whose
    launch call lies inside a kernels.launch span."""
    spans = launch_spans(roots, anchor)
    starts = [s for s, _, _, _ in spans]
    out = []
    for op in ops:
        if op.launched_ns is None:
            continue
        i = bisect.bisect_right(starts, op.launched_ns) - 1
        if i >= 0 and op.launched_ns <= spans[i][1]:
            out.append((op, spans[i][2], spans[i][3]))
    return out


def per_forward_ms(roots: list, names: tuple, self_time: bool = False
                   ) -> list[float] | None:
    """Host ms of the spans named ``names`` in each forward (their self
    time with ``self_time``), or None where no forward has one."""
    per, found = [], False
    for root in roots:
        spans = [s for s in root.walk() if s.name in names]
        found = found or bool(spans)
        per.append(1e3 * sum(s.self_time_s() if self_time else s.duration_s
                             for s in spans))
    return per if found else None


def route_roofline(ops_table: list, peak: dict, matched: list,
                   route: str) -> float | None:
    """The least time the card could take for the route's dispatches (the
    benchmark's own ``work.Op`` of each layer, by name) over the device
    time of the kernels matched to them, in %; None where the route has
    no matched kernel or a dispatch the table does not name."""
    by_name = {o.name: o for o in ops_table}
    least = device = 0.0
    for op, launch, conv in matched:
        if launch.attrs.get("route") not in ROUTES[route]:
            continue
        layer = by_name.get(conv.attrs.get("layer")) if conv else None
        if layer is None:
            return None
        least += work.least_seconds([layer], peak["flops_per_s"],
                                    peak["bytes_per_s"])
        device += (op.end_ns - op.start_ns) / 1e9
    return 100.0 * least / device if device > 0 else None


def _runner(c: spec.Cell, seed: int) -> harness.Runner:
    params, pool = harness.draw(c, seed, torch.device("cuda"))
    b = c.batch
    runner = harness.Runner(c.arch().program(c.config), params,
                            [pool[i:i + b] for i in range(0, len(pool), b)])
    runner.steps(c.traffic["warmup_forwards"])
    return runner


def _profiled(runner: harness.Runner, n: int, trace):
    """(capture, device ops, window, clock ok) of n traced steps under the
    profiler: the first try whose device clock agrees with its host clock
    (``clock_ok``), else the last try that recorded device ops; None if
    every try lost the device's events."""
    from torch.profiler import ProfilerActivity, profile
    got = None
    for _ in range(TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with trace.capture() as cap:
                t0 = time.perf_counter()
                runner.steps(n)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        ops = device_ops(prof.profiler.kineto_results.events())
        if ops:
            ok = clock_ok(cap.spans, cap.anchor, ops)
            got = (cap, ops, (cap.anchor.epoch_ns(t0),
                              cap.anchor.epoch_ns(t1)), ok)
            if ok:
                break
    return got


def run(c: spec.Cell, seed: int = SEED) -> Passes | None:
    """The two traced passes of ``c``'s ``profiled_forwards`` on the card,
    or None where the program has no anchored spans or the profiler lost
    every try's events.  The garbage collector is off in both: the spans
    are garbage the untraced program does not make, and a collection
    landing in one would be counted to it."""
    trace = tracing.recorder()
    if trace is None:
        return None
    runner = _runner(c, seed)
    n = c.traffic["profiled_forwards"]
    gc.collect()
    gc.disable()
    try:
        with trace.capture() as host:
            enqueue = [runner.step(i % len(runner.slots))[1]
                       for i in range(n)]
        got = _profiled(runner, n, trace)
    finally:
        gc.enable()
    if got is None:
        return None
    cap, ops, window, ok = got
    return Passes(n, enqueue, host.spans, cap.spans, cap.anchor, ops, window,
                  ok)


def summary(r, p: Passes) -> dict:
    """What the stderr line gives: the host's self time by span, the idle
    split, every route's roofline and the matching's counts, a forward
    each."""
    n = p.forwards
    self_ms: dict[str, float] = {}
    for root in p.host:
        for s in root.walk():
            self_ms[s.name] = self_ms.get(s.name, 0.0) + s.self_time_s() * 1e3
    idle = (idle_by_span(p.ops, innermost(p.profiled, p.anchor), p.window_ns)
            if p.clock_ok else None)
    matched = matches(p.profiled, p.anchor, p.ops)
    lead = sorted((op.start_ns - _ns(launch, p.anchor)[0]) / 1e3
                  for op, launch, _ in matched)
    return {
        "forwards": n,
        "enqueue_ms_traced": statistics.median(p.enqueue_ms),
        "enqueue_ms_window": (statistics.median(r.window.enqueue_ms)
                              if r.window.enqueue_ms else None),
        "host_self_ms_by_span": {k: v / n for k, v in self_ms.items()},
        "idle_ms_by_host_span": ({k: v / 1e6 / n for k, v in idle.items()}
                                 if idle is not None else None),
        "device_clock_ok": p.clock_ok,
        "route_roofline": {route: (route_roofline(r.ops, r.peak, matched,
                                                  route)
                                   if r.peak else None)
                           for route in ROUTES},
        "device_ops": len(p.ops) / n,
        "launch_spans": len(launch_spans(p.profiled, p.anchor)) / n,
        "matched_kernels": len(matched) / n,
        "launch_to_kernel_us": [lead[0], statistics.median(lead)]
        if lead else None,
    }


_last: list = []               # [(reading, passes)] of the last reading


def passes(r) -> Passes | None:
    """The passes of a ``--trace 1`` run's reading, run once for all its
    readers; None without a device trace (no CUDA) or without the
    program's anchored spans."""
    if _last and _last[0][0] is r:
        return _last[0][1]
    p = run(r.cell) if r.profile is not None else None
    _last[:] = [(r, p)]
    if p is not None:
        print(json.dumps({"host_spans": summary(r, p)}), file=sys.stderr,
              flush=True)
    return p


def host_metric(r, names: tuple, self_time: bool = False) -> float | None:
    """Median over the spans-only pass of a forward's host ms in the spans
    named ``names``."""
    p = passes(r)
    per = per_forward_ms(p.host, names, self_time) if p else None
    return statistics.median(per) if per else None


def roofline_metric(r, route: str) -> float | None:
    p = passes(r)
    if p is None or r.peak is None:
        return None
    return route_roofline(r.ops, r.peak, matches(p.profiled, p.anchor, p.ops),
                          route)


def setup_load_s(r) -> float | None:
    """Seconds of every first library load in the process (``kernels.load``
    spans, kept by the program whether tracing is on or not); None where
    the program keeps none or loaded nothing."""
    loads = tracing.library_loads()
    return sum(s.duration_s for s in loads) if loads else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True, help="the Perfetto JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the profiled pass needs a CUDA device", file=sys.stderr)
        return 2
    trace = tracing.recorder()
    if trace is None:
        print("the program's spans have no clock anchor", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    runner = _runner(c, args.seed)
    got = _profiled(runner, c.traffic["profiled_forwards"], trace)
    if got is None:
        print("the profiler recorded no device op", file=sys.stderr)
        return 3
    cap, ops, _, ok = got
    if not ok:
        print(f"the profiler's device clock slipped in {TRIES} tries: the "
              "device ops are drawn where it put them", file=sys.stderr)
    tracing.export(args.out, cap.spans, cap.anchor,
                   [(o.start_ns, o.end_ns, o.name) for o in ops])
    print(f"{args.out}: {sum(1 for s in cap.spans for _ in s.walk())} spans,"
          f" {len(ops)} device ops")
    return 0


if __name__ == "__main__":
    sys.exit(main())
