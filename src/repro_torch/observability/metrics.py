"""Counters and rolling latency percentiles for the serving/training loops.

Spans (``trace.py``) answer "what did this one dispatch cost"; metrics answer
"what is the loop doing over time" — requests admitted, tokens generated,
step-latency p50/p95/p99.  Both sides stay dependency-free (stdlib only) so
they can run inside the train step callback and the serving scheduler without
perturbing what they measure.  A copy of ``repro.observability.metrics``:
the port keeps its own and imports nothing of ``repro``.
"""
from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclass
class Gauge:
    """A value that can go up and down (queue depth, active slots, ...)."""

    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


# Default latency buckets (seconds): sub-ms kernel dispatches through
# multi-second cold compiles.  Chosen once and fixed so exposition series
# stay label-stable across runs.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: cumulative buckets).

    ``bucket_counts[i]`` counts observations <= ``buckets[i]`` (non-cumulative
    storage; exposition renders the cumulative form plus the implicit +Inf
    bucket).  ``sum``/``count`` are lifetime totals like ``LatencyWindow``'s.
    """

    def __init__(self, name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * len(self.buckets)
        self.inf_count = 0
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        i = bisect.bisect_left(self.buckets, value)
        if i < len(self.buckets):
            self.bucket_counts[i] += 1
        else:
            self.inf_count += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """[(upper_bound, cumulative_count), ...] ending with (inf, count)."""
        out, running = [], 0
        for ub, n in zip(self.buckets, self.bucket_counts):
            running += n
            out.append((ub, running))
        out.append((float("inf"), self.count))
        return out

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "buckets": {str(ub): c for ub, c in self.cumulative()}}


class LatencyWindow:
    """Rolling window of the last ``maxlen`` latencies with percentile reads.

    Keeps a parallel sorted list (insort/remove are O(window) on a few
    thousand floats — negligible next to the steps being timed) so
    ``percentile`` is O(1) and exact over the window, not an estimate.
    """

    def __init__(self, name: str, maxlen: int = 2048):
        self.name = name
        self.maxlen = maxlen
        self._window: deque[float] = deque()
        self._sorted: list[float] = []
        self.count = 0          # lifetime observations, not just the window
        self.total_s = 0.0      # lifetime sum

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self._window.append(seconds)
        bisect.insort(self._sorted, seconds)
        if len(self._window) > self.maxlen:
            old = self._window.popleft()
            del self._sorted[bisect.bisect_left(self._sorted, old)]

    def percentile(self, p: float) -> float:
        """Exact percentile over the current window (p in [0, 100])."""
        if not self._sorted:
            return 0.0
        idx = min(len(self._sorted) - 1,
                  max(0, round(p / 100.0 * (len(self._sorted) - 1))))
        return self._sorted[idx]

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": self.mean_s * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p90_ms": self.percentile(90) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
        }

    def format(self) -> str:
        s = self.summary()
        return (f"{self.name}: n={s['count']} mean={s['mean_ms']:.1f}ms "
                f"p50={s['p50_ms']:.1f}ms p90={s['p90_ms']:.1f}ms "
                f"p99={s['p99_ms']:.1f}ms")


@dataclass
class MetricsRegistry:
    """Named counters/gauges/histograms + latency windows; one per loop."""

    counters: dict[str, Counter] = field(default_factory=dict)
    gauges: dict[str, Gauge] = field(default_factory=dict)
    histograms: dict[str, Histogram] = field(default_factory=dict)
    latencies: dict[str, LatencyWindow] = field(default_factory=dict)

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(name)
        return self.counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self.gauges:
            self.gauges[name] = Gauge(name)
        return self.gauges[name]

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(name, buckets)
        return self.histograms[name]

    def latency(self, name: str, maxlen: int = 2048) -> LatencyWindow:
        if name not in self.latencies:
            self.latencies[name] = LatencyWindow(name, maxlen)
        return self.latencies[name]

    def snapshot(self) -> dict:
        snap = {
            "counters": {k: c.value for k, c in self.counters.items()},
            "latencies": {k: lw.summary() for k, lw in self.latencies.items()},
        }
        if self.gauges:
            snap["gauges"] = {k: g.value for k, g in self.gauges.items()}
        if self.histograms:
            snap["histograms"] = {k: h.summary()
                                  for k, h in self.histograms.items()}
        return snap

    def format(self) -> str:
        lines = [f"{k}={c.value:g}" for k, c in sorted(self.counters.items())]
        lines += [f"{k}={g.value:g}" for k, g in sorted(self.gauges.items())]
        lines += [f"{k}: n={h.count} sum={h.sum:g}"
                  for k, h in sorted(self.histograms.items())]
        lines += [lw.format() for _, lw in sorted(self.latencies.items())]
        return "\n".join(lines)
