"""Device time of a call from a cold L2 cache, with CUDA events.

The one timer of the port: the tuner (``launch.tune``), the bench record
(``bench.telemetry_report``), ``bench.kernel_bench`` and ``chip_smoke.py``
all measure through it, so their numbers are comparable.

Before each call the stream sleeps (about half a millisecond) and then
overwrites ``FLUSH_BYTES``, more than the H100's 50 MB L2.  The host
enqueues the events and the call while the device still sleeps, so the
events time the device's work and not the host's launch overhead.  The
flush is a memset: it leaves dirty L2 lines that a memory-bound timed call
writes back, so its time includes that.
"""
from __future__ import annotations

import statistics

import torch

SLEEP_CYCLES = 1_000_000     # ~0.5 ms of device time at H100 clocks
FLUSH_BYTES = 64 * 2 ** 20   # more than the H100's 50 MB L2
REPS = 10


def flush_buffer(device="cuda") -> torch.Tensor:
    """The buffer the timer overwrites before each call."""
    return torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)


def cold_times_ms(fn, flush: torch.Tensor, reps: int = REPS) -> list[float]:
    """Device time of each of ``reps`` calls of fn() from a cold L2 (after
    one warm call)."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in zip(starts, ends)]


def cold_time_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Mean device time of fn() from a cold L2 (``cold_times_ms``)."""
    return statistics.fmean(cold_times_ms(fn, flush, reps))
