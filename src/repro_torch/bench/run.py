"""Benchmark entry point: the paper's tables, the fidelity gate, the kernel
bench, the dry run's roofline tables, and the bench record.

    PYTHONPATH=src python -m repro_torch.bench.run [--skip-kernels]
        [--smoke] [--bench-json OUT] [--tuned] [--sparse]
        [--impl auto|cuda|ref] [--device cuda|cpu] [--bench-reps N]

The port's counterpart of ``benchmarks/run.py``.  It prints every table of
``bench.paper_figures`` and fails unless the analytic model's headline
numbers hold the paper's (the fidelity gate); on the card, unless
``--skip-kernels`` or ``--smoke``, the kernel bench (``bench.kernel_bench``);
and the roofline tables of the port's dry-run records, where there are any.

``--bench-json`` measures the ResNet-50 and VGG-16 layer sets, unfused and
through the fused-epilogue path, and the smoke sets, and writes the bench
record (``bench.telemetry_report.collect_bench``) that
``bench.check_regression`` gates against.  ``--sparse`` adds the
structured-sparse twins (``sparse_delta``); ``--tuned`` turns the tuning
cache on and adds the tuned-vs-default device times (``tuning``; the card
only).  ``--smoke`` keeps it to the smoke sets.  On the card the record's
times are cold-L2 device times; with ``--device cpu`` (``--impl ref``)
they are host times, and the record says so (``timer``).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..models.convert import resolve_device
from .timer import REPS


def _print_table(title, headers, rows, max_rows=60):
    print(f"\n=== {title} ===")
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows
              else len(str(h)) for i, h in enumerate(headers)]
    line = "  ".join(str(h).ljust(w) for h, w in zip(headers, widths))
    print(line)
    print("-" * len(line))
    shown = rows if len(rows) <= max_rows else rows[:max_rows]
    for r in shown:
        print("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    if len(rows) > max_rows:
        print(f"... ({len(rows) - max_rows} more rows)")


def fidelity_gate() -> bool:
    """Print the headline analytic numbers beside the paper's; all hold?"""
    from ..core.cost_model import resnet50_cost, vgg16_cost
    checks = [
        ("ResNet-50 ms", resnet50_cost().time_ms, 92.7, 0.005),
        ("ResNet-50 MB", resnet50_cost().dram_mb, 124.0, 0.005),
        ("sparse ms", resnet50_cost(sparse=True).time_ms, 42.5, 0.005),
        ("sparse MB", resnet50_cost(sparse=True).dram_mb, 63.3, 0.011),
        ("VGG-16 ms", vgg16_cost().time_ms, 396.9, 0.011),
        ("VGG-16 MB", vgg16_cost().dram_mb, 258.2, 0.005),
    ]
    print("\n=== Paper-fidelity gate ===")
    ok = True
    for name, got, want, tol in checks:
        rel = abs(got - want) / want
        status = "PASS" if rel <= tol else "FAIL"
        ok &= status == "PASS"
        print(f"{status} {name:16s} got {got:8.2f}  paper {want:8.2f}  "
              f"delta {rel * 100:5.2f}% (tol {tol * 100:.1f}%)")
    return ok


def bench_nets(smoke: bool, sparse: bool) -> list[str]:
    """The networks of a bench record: each measured unfused and fused (the
    ``_fused`` runs also record the per-block fused-vs-unfused delta); the
    full record carries the smoke sets too, for ``check_regression
    --smoke``; sparse twins ride along with ``sparse``."""
    nets = (["smoke", "smoke_fused"] if smoke
            else ["smoke", "smoke_fused",
                  "resnet50", "resnet50_fused", "vgg16", "vgg16_fused"])
    if sparse:
        nets += (["smoke_sparse"] if smoke
                 else ["smoke_sparse", "resnet50_sparse"])
    return nets


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-kernels", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="analytic tables + fidelity gate only; "
                         "--bench-json uses the tiny smoke layer sets")
    ap.add_argument("--bench-json", default=None,
                    help="measure the conv layer sets and write the bench "
                         "record here")
    ap.add_argument("--bench-reps", type=int, default=REPS,
                    help="timed dispatches per layer (the median is kept)")
    ap.add_argument("--tuned", action="store_true",
                    help="enable the tuning cache for --bench-json and add "
                         "the tuned-vs-default deltas (the card only)")
    ap.add_argument("--sparse", action="store_true",
                    help="also measure the structured-sparse twins and add "
                         "the dense-vs-sparse per-layer deltas")
    ap.add_argument("--impl", choices=["auto", "cuda", "ref"], default="auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from . import paper_figures
    for fn in paper_figures.ALL:
        _print_table(*fn())
    ok = fidelity_gate()

    if not (args.skip_kernels or args.smoke) and dev.type == "cuda":
        from .kernel_bench import kernel_table
        _print_table(*kernel_table()[:3])

    if not args.smoke:
        from .roofline import roofline_table
        for mesh in ("single", "multi"):
            title, headers, rows = roofline_table(mesh)
            if rows:
                _print_table(title, headers, rows)

    if args.bench_json:
        from .telemetry_report import collect_bench
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        record = collect_bench(bench_nets(args.smoke, args.sparse),
                               reps=1 if args.smoke else args.bench_reps,
                               impl=args.impl, smoke=args.smoke,
                               tuned=args.tuned, device=dev)
        with open(args.bench_json, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        n_layers = sum(len(v["layers"]) for v in record["networks"].values())
        print(f"\nbench record ({record['timer']}, {record['device']}): "
              f"{n_layers} layers over {'/'.join(record['networks'])} -> "
              f"{args.bench_json}")
        for net, r in record["networks"].items():
            print(f"{net}: {r['total_measured_ms']:.4f} ms measured, "
                  f"{r['total_host_ms']:.3f} ms host clock, "
                  f"{len(r['layers'])} layers")
        for net, fd in record.get("fused_delta", {}).items():
            worst = min(fd["blocks"], key=lambda b: b["saved_mb"])
            print(f"fused epilogue [{net}]: {fd['total_saved_mb']:.1f} MB "
                  f"saved over {len(fd['blocks'])} blocks, "
                  f"{fd['total_speedup']:.2f}x; min block saving "
                  f"{worst['saved_mb']:.2f} MB ({worst['block']})")
        for net, sd in record.get("sparse_delta", {}).items():
            print(f"sparse delta [{net}]: {sd['pruned_layers']} pruned "
                  f"layers touch {sd['total_saved_mb']:.1f} MB fewer bytes, "
                  f"{sd['total_dense_ms']:.4f} ms dense -> "
                  f"{sd['total_sparse_ms']:.4f} ms sparse "
                  f"({sd['total_speedup']:.2f}x)")
        for net, delta in record.get("tuning", {}).items():
            d, t = delta["total_default_ms"], delta["total_tuned_ms"]
            print(f"tuning [{net}]: defaults {d:.4f} ms -> tuned {t:.4f} ms "
                  f"({d / max(t, 1e-9):.2f}x) over {delta['keys_timed']} "
                  f"shape keys ({delta['keys_missing']} untuned)")

    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
