"""What the benchmark reads of the port's own tracing (``repro_torch.
observability``): its span recorder, where it has a clock anchor, the
library loads it keeps, and its Perfetto exporter.  ``hostspans.py`` reads
the program through these, as the rest of the benchmark reads it through
``archs/``."""
from __future__ import annotations


def recorder():
    """The program's span recorder, or None where it has no clock anchor
    (a program without the spans the benchmark reads)."""
    from repro_torch.observability import trace
    return trace if hasattr(trace, "Anchor") else None


def library_loads() -> list | None:
    """The ``kernels.load`` span of each library loaded in the process, or
    None where the program keeps none."""
    from repro_torch.kernels import _build
    return getattr(_build, "loads", None)


def export(path: str, spans: list, anchor, device_ops: list) -> None:
    """One Perfetto JSON file of the spans and the device ops
    ((start ns, end ns, name), the profiler's clock) on one timeline."""
    from repro_torch.observability.export import export_chrome_trace
    export_chrome_trace(spans, path, anchor=anchor, device_ops=device_ops)
