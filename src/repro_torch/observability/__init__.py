"""Tracing + metrics + export for the reconfigurable-dispatch stack.

``trace``   — span recorder (nesting, JSON export, zero-overhead disabled);
``metrics`` — counters/gauges/histograms and rolling latency percentiles;
``report``  — planned-vs-measured reconciliation (paper Table II mirror);
``export``  — Chrome/Perfetto ``trace_event`` JSON exporter;
``prom``    — Prometheus text exposition + stdlib HTTP exporter;
``events``  — structured JSONL event log for the control planes.

Import from the submodules, as ``repro.observability``'s are laid out.
"""
