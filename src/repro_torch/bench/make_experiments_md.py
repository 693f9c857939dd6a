"""Assemble a Markdown report from the port's dry-run records.

    PYTHONPATH=src python -m repro_torch.bench.make_experiments_md
        [--base experiments/dryrun_torch] [--opt DIR]
        [--out experiments/EXPERIMENTS_torch.md]

The port's counterpart of ``benchmarks/make_experiments_md.py``: the
paper-fidelity table (the analytic model, ``core.cost_model``), how many
dry-run cells have a record on each mesh, and the roofline table of each
mesh from the records ``launch.dryrun`` wrote (``--base``, the
paper-faithful ``--perf off`` by default); with ``--opt`` (a directory of
records traced under ``--perf on``) the single-mesh table gains the
optimized bound and the ratio.  Every number comes from those records or
the model: the hand-written hillclimb log of ``repro``'s report, measured
on its own target, is not copied.  A value a record lacks reads ``n/a``
(``bench.roofline.field``).
"""
from __future__ import annotations

import argparse
import os

from ..core.cost_model import resnet50_cost, vgg16_cost
from .roofline import DRYRUN_DIR, NA, REPO_ROOT, field, load_records
from .roofline import roofline_fraction

OUT = os.path.join(REPO_ROOT, "experiments", "EXPERIMENTS_torch.md")


def _bound_s(rec: dict):
    rf = rec.get("roofline", {})
    terms = [rf.get(k) for k in ("compute_s", "memory_s", "collective_s")]
    if any(not isinstance(t, (int, float)) for t in terms):
        return None
    return max(terms)


def _row(r: dict, opt: dict | None = None, with_opt: bool = False) -> list:
    cells = [r.get("arch", NA), r.get("shape", NA),
             field(r, "roofline", "compute_s", fmt="{:.1f}", scale=1e3),
             field(r, "roofline", "memory_s", fmt="{:.1f}", scale=1e3),
             field(r, "roofline", "collective_s", fmt="{:.1f}", scale=1e3),
             field(r, "roofline", "dominant"),
             field(r, "roofline", "useful_ratio", fmt="{:.2f}"),
             roofline_fraction(r).strip(),
             field(r, "memory", "peak_bytes", fmt="{:.1f}", scale=2 ** -30),
             field(r, "compile_s", fmt="{:.1f}")]
    if with_opt:
        b, o = _bound_s(r), _bound_s(opt) if opt else None
        cells += [f"{o * 1e3:.1f}" if o is not None else NA,
                  f"{b / o:.2f}x" if b is not None and o else NA]
    return cells


def _md_table(headers, rows) -> str:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join(["---"] * len(headers)) + "|"]
    out += ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return "\n".join(out)


def report(base_dir: str = DRYRUN_DIR, opt_dir: str | None = None) -> str:
    """The report's Markdown text."""
    r50, r50s, vgg = resnet50_cost(), resnet50_cost(sparse=True), vgg16_cost()
    lines = ["# EXPERIMENTS (port) — CARLA reproduction, PyTorch on the "
             "H100\n",
             "The dry-run cells are per-device counts of the traced eager "
             "step on fake 16x16 and 2x16x16 process groups "
             "(`launch.graph_analysis`), with roofline terms from the H100 "
             "SXM's published peaks (989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s "
             "NVLink): counts, not times measured on a card.\n",
             "## Paper fidelity (analytic model)\n",
             _md_table(["metric", "reproduced", "paper"], [
                 ["ResNet-50 latency", f"{r50.time_ms:.2f} ms", "92.7 ms"],
                 ["ResNet-50 DRAM", f"{r50.dram_mb:.2f} MB", "124.0 MB"],
                 ["sparse ResNet-50 latency", f"{r50s.time_ms:.2f} ms",
                  "42.5 ms"],
                 ["sparse ResNet-50 DRAM", f"{r50s.dram_mb:.2f} MB",
                  "63.3 MB"],
                 ["VGG-16 latency", f"{vgg.time_ms:.2f} ms", "396.9 ms"],
                 ["VGG-16 DRAM", f"{vgg.dram_mb:.2f} MB", "258.2 MB"]]),
             ""]
    hdr = ["arch", "shape", "comp ms", "mem ms", "coll ms", "bound",
           "useful", "roofl%", "GiB/dev", "compile s"]
    opt = ({(r["arch"], r["shape"]): r for r in load_records("single",
                                                             opt_dir)}
           if opt_dir else {})
    for mesh, name in (("single", "16x16"), ("multi", "2x16x16")):
        recs = load_records(mesh, base_dir)
        lines.append(f"## Dry run, {name} mesh ({len(recs)} cells with a "
                     f"record in `{os.path.relpath(base_dir, REPO_ROOT)}`)\n")
        with_opt = bool(opt) and mesh == "single"
        rows = [_row(r, opt.get((r.get("arch"), r.get("shape"))), with_opt)
                for r in recs]
        lines.append(_md_table(hdr + (["opt bound ms", "speedup"]
                                      if with_opt else []), rows))
        lines.append("")
    return "\n".join(lines) + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", default=DRYRUN_DIR,
                    help="dry-run records of the baseline")
    ap.add_argument("--opt", default=None,
                    help="dry-run records traced under --perf on")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    text = report(args.base, args.opt)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
