"""Regression gate: compare a bench record against the committed baseline.

    PYTHONPATH=src python -m repro_torch.bench.check_regression   # fresh run
    PYTHONPATH=src python -m repro_torch.bench.check_regression \
        --candidate other.json
    PYTHONPATH=src python -m repro_torch.bench.check_regression \
        --inject-slowdown 2            # must fail: the gate's self-test

The port's counterpart of ``benchmarks/check_regression.py``.  The baseline
(``BENCH_21.json`` at the repository root, written by ``bench.run
--bench-json --tuned --sparse`` on an H100) records per layer the measured
device time, achieved GFLOP/s and utilization of the ResNet-50 and VGG-16
layer sets (unfused, fused, structured-sparse) and of the smoke sets, the
per-bottleneck-block fused-vs-unfused bytes, the per-layer dense-vs-sparse
bytes and the tuned-vs-default device times.  The gate re-measures the same
sets (or loads ``--candidate``) and fails when a layer or a network total
slows past its band.  Two invariants are exact, not banded: every fused
block touches strictly fewer bytes than unfused, and every pruned layer
strictly fewer bytes than its dense twin.

The bands are for device time (``timer: cuda_event_cold_l2``: CUDA events
around each dispatch from a cold L2, the median of the reps), which
repeats within a few percent on one card, unlike the host clock.  They
were set from the spread of seven H100 records of the full set over four
calls (below, and ``PERF.md``): a layer may slow by ``LAYER_TOL`` plus
``LAYER_ABS_MS``, a network total by ``TOTAL_TOL`` plus
``TOTAL_ABS_MS``.  Getting faster never fails.  ``compare`` refuses to
band a device-timed record against a host-timed one (the CPU's ``--impl
ref`` records): they measure different things.

``--smoke`` compares only the ``smoke*`` networks.  ``--inject-slowdown F``
multiplies the candidate's measured times by F before comparing and
``--inject-sparse-violation`` raises every pruned layer's bytes to its dense
twin's: the self-tests that prove each check trips.  The stale-table check
fails when a committed tuned table (``kernels/tuned/*.h100.json``) was
measured against kernel sources other than the current ones.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_BASELINE = os.path.join(REPO_ROOT, "BENCH_21.json")

# Bands on device time, from seven records of the full set on H100 80GB
# HBM3 cards at 700 W over four calls (PERF.md section 5).  A full
# network's total spread at most 1.3 % (0.35-0.74 % within one call; 1.27 %
# above the baseline at worst), so a total may slow by 3 % (room for
# another H100's clocks) plus about one launch floor (~0.005 ms), which
# holds the ~0.05 ms smoke sets, whose totals spread up to 10 %.  A layer
# spread up to 4.7 % on the full networks and 19 % on the smoke sets'
# layers near the launch floor: +25 % plus the launch floor.
LAYER_TOL = 0.25
LAYER_ABS_MS = 0.005
TOTAL_TOL = 0.03
TOTAL_ABS_MS = 0.005
UTIL_TOL = 0.25      # relative drop allowed in mean util-vs-peak
# tuned-vs-default: the tuner kept a plan only where it beat the analytic
# one by more than its spread, so a tuned key slower than its default past
# this band means the committed table went stale in a way the hash misses
TUNED_TOL = 0.25
TUNED_ABS_MS = 0.005
# sparse-vs-dense time: a pruned layer runs a strict subset of its dense
# twin's MACs; the band absorbs the launch floor of the small layers
SPARSE_TOL = 0.25
SPARSE_ABS_MS = 0.005


def load(path: str) -> dict:
    with open(path) as f:
        rec = json.load(f)
    if "networks" not in rec:
        raise SystemExit(f"{path}: not a bench record (no 'networks' key)")
    return rec


def inject_slowdown(record: dict, factor: float) -> dict:
    """Scale every measured time by ``factor`` (gate self-test hook)."""
    rec = json.loads(json.dumps(record))
    for net in rec["networks"].values():
        net["total_measured_ms"] *= factor
        for layer in net["layers"]:
            layer["measured_ms"] *= factor
            layer["gflops"] /= factor
    for delta in rec.get("tuning", {}).values():
        for entry in delta["layers"]:
            if entry.get("tuned"):
                entry["tuned_ms"] *= factor
    # both sides of the sparse delta scale together: a global slowdown is
    # not a sparse-invariant violation
    for sd in rec.get("sparse_delta", {}).values():
        for entry in sd["layers"]:
            entry["dense_ms"] *= factor
            entry["sparse_ms"] *= factor
        sd["total_dense_ms"] *= factor
        sd["total_sparse_ms"] *= factor
    return rec


def inject_sparse_violation(record: dict) -> dict:
    """Raise every pruned layer's bytes to its dense twin's (self-test hook).

    The sparse invariant's bytes half is strict, so this must always trip
    the gate — mirroring what ``--inject-slowdown`` proves for the bands.
    """
    rec = json.loads(json.dumps(record))
    for sd in rec.get("sparse_delta", {}).values():
        for entry in sd["layers"]:
            if entry.get("pruned"):
                entry["sparse_bytes_mb"] = entry["dense_bytes_mb"]
                entry["saved_mb"] = 0.0
    return rec


def fused_bytes_problems(rec: dict) -> list[str]:
    """Each bottleneck block must touch strictly fewer bytes through the
    fused epilogue than unfused (exact: bytes are array footprints)."""
    return [f"{net}/{blk['block']}: fused path bytes "
            f"{blk['fused_bytes_mb']:.2f} MB not below unfused "
            f"{blk['unfused_bytes_mb']:.2f} MB"
            for net, fd in rec.get("fused_delta", {}).items()
            for blk in fd.get("blocks", [])
            if not blk["fused_bytes_mb"] < blk["unfused_bytes_mb"]]


def sparse_bytes_problems(rec: dict) -> list[str]:
    """Each pruned layer must touch strictly fewer bytes than its dense
    twin (exact)."""
    return [f"{net}/{e['layer']}: pruned layer touches "
            f"{e['sparse_bytes_mb']:.3f} MB, not strictly below its dense "
            f"twin's {e['dense_bytes_mb']:.3f} MB"
            for net, sd in rec.get("sparse_delta", {}).items()
            for e in sd.get("layers", [])
            if e.get("pruned") and not e["sparse_bytes_mb"]
            < e["dense_bytes_mb"]]


def check_bytes(rec: dict) -> list[str]:
    """The two exact invariants of a record: fused and pruned bytes."""
    return fused_bytes_problems(rec) + sparse_bytes_problems(rec)


def check_sparse(cand: dict, *, sparse_tol: float = SPARSE_TOL) -> list[str]:
    """The structured-sparsity invariant, per pruned layer vs its dense twin.

    Bytes are deterministic array footprints, so "strictly fewer" is exact;
    times get the ``sparse_tol`` band plus absolute slack.
    """
    problems = sparse_bytes_problems(cand)
    for net, sd in cand.get("sparse_delta", {}).items():
        for entry in sd.get("layers", []):
            if not entry.get("pruned"):
                continue
            sm, dm = entry["sparse_ms"], entry["dense_ms"]
            if sm > dm * (1 + sparse_tol) + SPARSE_ABS_MS:
                problems.append(
                    f"{net}/{entry['layer']}: pruned layer {sm:.4f} ms vs "
                    f"dense twin {dm:.4f} ms "
                    f"(+{(sm / dm - 1) * 100:.0f}% > {sparse_tol * 100:.0f}%)")
    return problems


def check_tuning(cand: dict, *, tuned_tol: float = TUNED_TOL) -> list[str]:
    """Tuned plans must never lose to the analytic plans beyond the band."""
    problems: list[str] = []
    for net, delta in cand.get("tuning", {}).items():
        for entry in delta.get("layers", []):
            if not entry.get("tuned"):
                continue
            d, t = entry["default_ms"], entry["tuned_ms"]
            if t > d * (1 + tuned_tol) + TUNED_ABS_MS:
                problems.append(
                    f"{net}/{entry['layer']} [{entry['tile_config']}]: tuned "
                    f"{t:.4f} ms vs default {d:.4f} ms "
                    f"(+{(t / d - 1) * 100:.0f}% > {tuned_tol * 100:.0f}%)")
    return problems


def check_stale_tables() -> list[str]:
    """Committed tuned tables must match the current kernel-signature hash."""
    from ..core import autotune
    autotune.reset()
    try:
        stale = autotune.stale_tables()
    finally:
        autotune.reset()
    return [
        f"stale tuned table {s['path']}: tuned against kernel hash "
        f"{s['table_hash']}, sources now hash {s['current_hash']} — re-run "
        "repro_torch.launch.tune --commit"
        for s in stale
    ]


def compare(base: dict, cand: dict, *, layer_tol: float = LAYER_TOL,
            total_tol: float = TOTAL_TOL,
            util_tol: float = UTIL_TOL) -> list[str]:
    """Return a list of regression descriptions (empty = gate passes).
    Raises ``ValueError`` for records timed by different clocks."""
    bt_, ct_ = base.get("timer", "host"), cand.get("timer", "host")
    if bt_ != ct_:
        raise ValueError(f"baseline timed by {bt_!r}, candidate by {ct_!r}: "
                         "the two clocks measure different things and are "
                         "not banded against each other")
    problems: list[str] = []
    for net, b in base["networks"].items():
        c = cand["networks"].get(net)
        if c is None:
            problems.append(f"{net}: missing from candidate record")
            continue
        bt, ct = b["total_measured_ms"], c["total_measured_ms"]
        if ct > bt * (1 + total_tol) + TOTAL_ABS_MS:
            problems.append(
                f"{net}: total {ct:.4f} ms vs baseline {bt:.4f} ms "
                f"(+{(ct / bt - 1) * 100:.0f}% > {total_tol * 100:.0f}%)")
        cl = {layer["layer"]: layer for layer in c["layers"]}
        for bl in b["layers"]:
            l = cl.get(bl["layer"])
            if l is None:
                problems.append(f"{net}/{bl['layer']}: missing layer")
                continue
            if l["dataflow"] != bl["dataflow"]:
                problems.append(
                    f"{net}/{bl['layer']}: dataflow changed "
                    f"{bl['dataflow']} -> {l['dataflow']}")
            if l.get("epilogue", "none") != bl.get("epilogue", "none"):
                problems.append(
                    f"{net}/{bl['layer']}: epilogue changed "
                    f"{bl.get('epilogue')} -> {l.get('epilogue')}")
            if l["measured_ms"] > (bl["measured_ms"] * (1 + layer_tol)
                                   + LAYER_ABS_MS):
                problems.append(
                    f"{net}/{bl['layer']}: {l['measured_ms']:.4f} ms vs "
                    f"baseline {bl['measured_ms']:.4f} ms "
                    f"(+{(l['measured_ms'] / bl['measured_ms'] - 1) * 100:.0f}%"
                    f" > {layer_tol * 100:.0f}%)")
        b_util = sum(x["util_vs_peak"] for x in b["layers"]) / len(b["layers"])
        c_util = sum(x["util_vs_peak"] for x in c["layers"]) / len(c["layers"])
        if b_util > 0 and c_util < b_util * (1 - util_tol):
            problems.append(
                f"{net}: mean util {c_util:.2f} vs baseline {b_util:.2f} "
                f"(-{(1 - c_util / b_util) * 100:.0f}% > {util_tol * 100:.0f}%)")
    # the fused-path invariant is exact, not banded
    return problems + fused_bytes_problems(cand)


def worst_ratio(base: dict, cand: dict) -> tuple[float, str]:
    """The largest candidate / baseline measured time over every layer and
    network total the two records share, and where it is."""
    worst = (0.0, "")
    for net, b in base["networks"].items():
        c = cand["networks"].get(net)
        if c is None:
            continue
        worst = max(worst, (c["total_measured_ms"]
                            / max(b["total_measured_ms"], 1e-12), net))
        cl = {l["layer"]: l for l in c["layers"]}
        for bl in b["layers"]:
            if bl["layer"] in cl:
                worst = max(worst, (cl[bl["layer"]]["measured_ms"]
                                    / max(bl["measured_ms"], 1e-12),
                                    f"{net}/{bl['layer']}"))
    return worst


def smoke_only(rec: dict) -> dict:
    """The record cut to its ``smoke*`` networks and their deltas."""
    out = dict(rec)
    for key in ("networks", "fused_delta", "sparse_delta", "tuning"):
        out[key] = {k: v for k, v in rec.get(key, {}).items()
                    if k.startswith("smoke")}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--candidate", default=None,
                    help="a bench record to compare; omit to measure fresh")
    ap.add_argument("--tolerance", type=float, default=LAYER_TOL,
                    help="per-layer relative slowdown band")
    ap.add_argument("--total-tolerance", type=float, default=TOTAL_TOL)
    ap.add_argument("--util-tolerance", type=float, default=UTIL_TOL)
    ap.add_argument("--tuned-tolerance", type=float, default=TUNED_TOL,
                    help="band for the tuned-vs-default check")
    ap.add_argument("--sparse-tolerance", type=float, default=SPARSE_TOL,
                    help="band for the pruned-vs-dense-twin check")
    ap.add_argument("--skip-stale-check", action="store_true",
                    help="skip the committed-table kernel-hash check")
    ap.add_argument("--inject-slowdown", type=float, default=1.0,
                    help="scale candidate times by this factor (self-test)")
    ap.add_argument("--inject-sparse-violation", action="store_true",
                    help="raise pruned layers' bytes to their dense twins' "
                         "(sparse-invariant self-test)")
    ap.add_argument("--smoke", action="store_true",
                    help="compare (and measure) only the smoke layer sets")
    ap.add_argument("--reps", type=int, default=0,
                    help="reps for a fresh run (0 = baseline's reps)")
    args = ap.parse_args(argv)

    base = load(args.baseline)
    smoke = args.smoke or base.get("smoke", False)
    if smoke:
        base = smoke_only(base)
        if not base["networks"]:
            raise SystemExit(f"{args.baseline}: no smoke networks to compare")
    if args.candidate:
        cand = load(args.candidate)
    else:
        from .telemetry_report import collect_bench
        nets = list(base["networks"])
        reps = args.reps or base.get("reps", 10)
        device = base.get("backend", "cuda")
        print(f"measuring {'/'.join(nets)} fresh on {device} "
              f"(reps={reps}, impl={base.get('impl', 'auto')})...")
        cand = collect_bench(nets, batch=base.get("batch", 1), reps=reps,
                             impl=base.get("impl", "auto"), smoke=smoke,
                             tuned=base.get("tuned", False), device=device)
    if args.inject_slowdown != 1.0:
        cand = inject_slowdown(cand, args.inject_slowdown)
        print(f"(injected {args.inject_slowdown}x slowdown into candidate)")
    if args.inject_sparse_violation:
        cand = inject_sparse_violation(cand)
        print("(injected sparse-invariant violation into candidate)")
    if base.get("device") != cand.get("device"):
        print(f"note: baseline measured on {base.get('device')}, candidate "
              f"on {cand.get('device')}")

    try:
        problems = compare(base, cand, layer_tol=args.tolerance,
                           total_tol=args.total_tolerance,
                           util_tol=args.util_tolerance)
    except ValueError as e:
        raise SystemExit(f"perf gate: {e}") from None
    problems += check_tuning(cand, tuned_tol=args.tuned_tolerance)
    problems += check_sparse(cand, sparse_tol=args.sparse_tolerance)
    if not args.skip_stale_check:
        problems += check_stale_tables()
    for net, b in sorted(base["networks"].items()):
        c = cand["networks"].get(net)
        if c:
            print(f"{net}: baseline {b['total_measured_ms']:.4f} ms -> "
                  f"candidate {c['total_measured_ms']:.4f} ms "
                  f"({len(b['layers'])} layers)")
    for net, sd in sorted(cand.get("sparse_delta", {}).items()):
        print(f"{net} sparse: {sd['pruned_layers']} pruned layers, "
              f"{sd['total_saved_mb']:.2f} MB fewer bytes, "
              f"{sd['total_dense_ms']:.4f} -> {sd['total_sparse_ms']:.4f} ms")
    for net, delta in sorted(cand.get("tuning", {}).items()):
        d, t = delta["total_default_ms"], delta["total_tuned_ms"]
        print(f"{net} tuning: defaults {d:.4f} ms -> tuned {t:.4f} ms over "
              f"{delta['keys_timed']} keys "
              f"({delta['keys_missing']} untuned)")
    ratio, where = worst_ratio(base, cand)
    print(f"worst candidate / baseline: {ratio:.3f} ({where})")
    if problems:
        print(f"\nPERF REGRESSION ({len(problems)}):")
        for p in problems:
            print(f"  - {p}")
        sys.exit(1)
    print("\nperf gate: PASS (no regression beyond tolerance)")


if __name__ == "__main__":
    main()
