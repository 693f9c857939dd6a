"""Launchers: ``serve`` (prefill, then greedy decode)."""
