"""Telemetry: the span recorder (``trace``)."""
