"""Pytest config: make `src` importable and make optional-dep skips visible.

The suite must collect with zero errors on a bare container: `hypothesis`
and `zstandard` are optional (property tests fall back to deterministic
grids; checkpoints fall back to the stdlib zlib codec).  This header makes
any degraded mode explicit in every test run instead of a silent skip.
"""
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "src"))

OPTIONAL_DEPS = {
    "hypothesis": "randomized property tests (deterministic grids still run)",
    "zstandard": "zstd checkpoint codec (stdlib zlib fallback active)",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess/e2e tests (benchmark CLI liveness)")
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


def pytest_report_header(config):
    lines = []
    for mod, consequence in sorted(OPTIONAL_DEPS.items()):
        if importlib.util.find_spec(mod) is None:
            lines.append(f"optional dep MISSING: {mod} -> {consequence}")
        else:
            lines.append(f"optional dep present: {mod}")
    return lines
