"""Roofline table from the port's dry-run records
(``experiments/dryrun_torch/*.json``, written by ``launch.dryrun``).

Per (arch x shape x mesh): the three roofline terms, the dominant one,
MODEL_FLOPS / counted FLOPs (useful-compute ratio), the roofline fraction
(compute term / dominant term) and the peak memory per device, as
``benchmarks/roofline.py`` prints them for ``repro``'s records.  The port's
records count the ops of the traced eager step (``launch.graph_analysis``)
where ``repro``'s come from compiled HLO, and some of ``repro``'s keys do
not carry over (no ``compile_s``, no XLA cost analysis): a column whose key
a record lacks reads ``n/a``, never an invented value.
"""
from __future__ import annotations

import json
import os

from ..launch.dryrun import DEFAULT_OUT

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DRYRUN_DIR = os.path.join(REPO_ROOT, DEFAULT_OUT)
NA = "n/a"


def field(rec: dict, *path, fmt: str = "{}", scale: float = 1.0) -> str:
    """``rec[path[0]][path[1]]...`` formatted, or ``n/a`` when a key is
    missing or not a number where one is scaled."""
    v = rec
    for key in path:
        if not isinstance(v, dict) or key not in v:
            return NA
        v = v[key]
    if scale != 1.0:
        if not isinstance(v, (int, float)):
            return NA
        v = v * scale
    return fmt.format(v)


def roofline_fraction(rec: dict) -> str:
    """compute term / dominant term, or ``n/a``."""
    rf = rec.get("roofline", {})
    terms = [rf.get(k) for k in ("compute_s", "memory_s", "collective_s")]
    if any(not isinstance(t, (int, float)) for t in terms) or not max(terms):
        return NA
    return f"{terms[0] / max(terms) * 100:5.1f}%"


def load_records(mesh: str = "single", directory: str = DRYRUN_DIR
                 ) -> list[dict]:
    """The records of one mesh (``single`` 16x16, ``multi`` 2x16x16)."""
    recs = []
    if not os.path.isdir(directory):
        return recs
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(f"__{mesh}.json"):
            with open(os.path.join(directory, fn)) as f:
                recs.append(json.load(f))
    return recs


def roofline_table(mesh: str = "single", directory: str = DRYRUN_DIR):
    rows = []
    for r in load_records(mesh, directory):
        rows.append([
            r.get("arch", NA), r.get("shape", NA),
            field(r, "roofline", "compute_s", fmt="{:9.1f}", scale=1e3),
            field(r, "roofline", "memory_s", fmt="{:9.1f}", scale=1e3),
            field(r, "roofline", "collective_s", fmt="{:9.1f}", scale=1e3),
            field(r, "roofline", "dominant"),
            field(r, "roofline", "useful_ratio", fmt="{:.3f}"),
            roofline_fraction(r),
            field(r, "memory", "peak_bytes", fmt="{:6.2f}", scale=2 ** -30),
            field(r, "lower_s", fmt="{:.1f}"),
            field(r, "compile_s", fmt="{:.1f}"),
        ])
    return (f"Roofline — {mesh} mesh, the port's dry run "
            "(terms in ms/step; frac = compute/dominant)",
            ["arch", "shape", "compute", "memory", "collective", "bound",
             "useful", "roofline%", "peakGiB", "trace s", "compile s"], rows)
