"""Analytic-vs-measured reconciliation report (paper Table II, both sides),
and the bench record behind the regression gate.

    PYTHONPATH=src python -m repro_torch.bench.telemetry_report
        [--net resnet50] [--batch 1] [--reps 10] [--limit N]
        [--impl auto|cuda|ref] [--device cuda|cpu] [--json out.json]
        [--chrome out.trace.json] [--smoke] [--fused] [--tuned] [--sparse]
        [--skip-overhead]

The port's counterpart of ``benchmarks/telemetry_report.py``.  Every conv
layer of ResNet-50 (VGG-16 with ``--net vgg16``) runs through
``core.carla.carla_conv`` with tracing on, and per layer the report prints
the analytic side (ASIC model, batch 1: cycles, ms at 200 MHz, DRAM MB,
PUF) beside the measured one (ms, array MB touched, GFLOP/s, util % of the
run's best layer or ``--peak-gflops``).  ``--fused``, ``--sparse``,
``--tuned`` and ``--smoke`` are ``repro``'s: the fused epilogue on every
layer, the structured-pruned twin (paper Table I) tagged with its dense
twin, the tuning cache on, and the tiny smoke layer set.

What "measured" means depends on the device, and the record says which
(``timer``):

* on the card (``cuda_event_cold_l2``): the median device time of
  ``reps`` untraced dispatches, each from a cold L2 (``bench.timer``: the
  stream sleeps, a 64 MB memset flushes the L2, CUDA events around the
  dispatch), the timer of ``chip_smoke.py``'s kernel rows and the tuner;
* on the CPU (``host``): the median host time of ``reps`` traced
  dispatches.

Each layer also keeps ``host_ms``, the median duration of its traced
``carla_conv`` span: the host's time from the call to its return (plan,
operand checks, launch; no span waits for the device).  It is never
banded: on the card the host clock spreads by 2x between runs of the same
code while device times repeat within a few percent.

``collect_bench`` is the measurement core of the bench record:
``bench.run --bench-json`` writes it and ``bench.check_regression``
compares a fresh one with the committed baseline.  ``measure_disabled_
overhead`` times the dispatch with tracing off against the kernel's own
wrapper (the zero-overhead gate of the tracing layer).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from ..core import autotune, networks
from ..core.carla import carla_conv
from ..core.cost_model import epilogue_dram_delta_bytes
from ..core.fuse import Epilogue
from ..core.sparsity import SparsityTag
from ..models.convert import resolve_device
from ..observability import trace
from ..observability.report import format_table, reconcile, totals
from .timer import REPS, cold_times_ms, flush_buffer

NET_LAYERS = {
    "resnet50": networks.resnet50_conv_layers,
    "vgg16": networks.vgg16_conv_layers,
    "smoke": networks.smoke_conv_layers,
}
# ``<net>_fused`` runs the same layer set with a per-layer fused epilogue
# (folded-BN scale/bias + ReLU; residual on the bottleneck-closing 1x1s).
FUSED_SUFFIX = "_fused"
# ``<net>_sparse`` runs the structured-pruned twin of the layer set, each
# pruned dispatch tagged with its dense twin (keep-fraction in the spans).
SPARSE_SUFFIX = "_sparse"
CUDA_TIMER, HOST_TIMER = "cuda_event_cold_l2", "host"


def timer_for(device) -> str:
    """The record's ``timer``: device time on the card, host time else."""
    return CUDA_TIMER if torch.device(device).type == "cuda" else HOST_TIMER


def card(device) -> dict:
    """The card's name and power limit (``nvidia-smi``'s), or the CPU."""
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": "not measured"}
    return {"name": autotune.device_name(),
            "power_limit": autotune.power_limit()}


def _sparsity_tags(base: str) -> tuple[list, dict[str, SparsityTag]]:
    """Sparse twin layer set of ``base`` + per-layer dense-twin tags."""
    layers = networks.sparse_conv_layers(base)
    dense = {l.name: l for l in NET_LAYERS[base]()}
    tags = {l.name: SparsityTag(dense_ic=dense[l.name].IC,
                                dense_k=dense[l.name].K)
            for l in layers
            if (dense[l.name].IC, dense[l.name].K) != (l.IC, l.K)}
    return layers, tags


def _randn(shape, seed: int, device) -> torch.Tensor:
    """Unit normals drawn on the CPU from ``seed`` (the same values on any
    device), then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device)


def _layer_operands(layer, batch: int, seed: int, device):
    x = _randn((batch, layer.IL, layer.IL, layer.IC), seed, device)
    w = (_randn((layer.FL, layer.FL, layer.IC, layer.K), seed + 1, device)
         * (layer.FL * layer.FL * layer.IC) ** -0.5)
    return x, w


def _wants_residual(layer) -> bool:
    """Layers that close a bottleneck block get the shortcut add fused in."""
    return layer.name.endswith("_1x1b") or layer.name.endswith("_ws")


def _layer_epilogue(layer, batch: int, seed: int, device) -> Epilogue:
    scale = 1.0 + 0.1 * _randn((layer.K,), seed, device)
    bias = 0.1 * _randn((layer.K,), seed + 1, device)
    residual = None
    if _wants_residual(layer):
        residual = _randn((batch, layer.OL, layer.OL, layer.K), seed + 2,
                          device)
    return Epilogue(scale=scale, bias=bias, relu=True, residual=residual)


def _measure(fn, reps: int, flush) -> tuple[float, list, float]:
    """(measured seconds, the spans of one traced call, host seconds) of
    ``reps`` calls of fn.

    Host: the median duration of the ``reps`` traced calls' root spans,
    each call followed, outside its span, by a synchronise.  Measured: on
    the card (``flush`` given) the median cold-L2 device time of ``reps``
    untraced calls, else the host time."""
    sync = torch.cuda.synchronize if flush is not None else (lambda: None)
    fn()                                                   # warm / build
    durations, spans = [], None
    for _ in range(reps):
        with trace.capture() as tr:
            fn()
        sync()
        spans = tr.spans
        durations.append(spans[0].duration_s)
    host_s = statistics.median(durations)
    if flush is None:
        return host_s, spans, host_s
    return (statistics.median(cold_times_ms(fn, flush, reps)) / 1e3, spans,
            host_s)


def run_network(layers, batch: int, reps: int, impl: str = "auto",
                fused: bool = False, sparsity=None, *, device="cuda"):
    """One ``carla_conv`` span per layer, its duration the layer's measured
    time (``_measure``: device time on the card, host time on the CPU) and
    its ``host_ms`` attribute the traced dispatches' median host time.

    ``sparsity``: optional ``{layer name: SparsityTag}`` for pruned layer
    sets — tagged dispatches record keep-fraction / dense-twin MACs."""
    dev = resolve_device(device)
    flush = flush_buffer(dev) if dev.type == "cuda" else None
    out = []
    for i, layer in enumerate(layers):
        x, w = _layer_operands(layer, batch, 2 * i, dev)
        kw = dict(stride=layer.S, padding=layer.Z, impl=impl, name=layer.name)
        if sparsity and layer.name in sparsity:
            kw["sparsity"] = sparsity[layer.name]
        if fused:
            kw["epilogue"] = _layer_epilogue(layer, batch, 1000 + 3 * i, dev)
        measured_s, (sp,), host_s = _measure(lambda: carla_conv(x, w, **kw),
                                             reps, flush)
        out.append(dataclasses.replace(
            sp, duration_s=measured_s,
            attrs={**sp.attrs, "host_ms": host_s * 1e3}))
    return out


# ----------------------- fused-vs-unfused block delta -------------------------
def _bottleneck_blocks(layers):
    """Group ResNet bottleneck triplets (1x1a, 3x3, 1x1b); anything else is
    its own single-layer 'block'."""
    blocks, i = [], 0
    while i < len(layers):
        l = layers[i]
        if (l.name.endswith("_1x1a") and i + 2 < len(layers)
                and layers[i + 1].name.endswith("_3x3")
                and layers[i + 2].name.endswith("_1x1b")):
            blocks.append((l.name[:-len("_1x1a")], layers[i:i + 3]))
            i += 3
        else:
            blocks.append((l.name, [l]))
            i += 1
    return blocks


def _run_block(layers, x0, weights, epilogues, fused: bool, impl: str):
    """One forward through a block (the unfused side applies each
    epilogue as separate element-wise passes)."""
    x = x0
    for layer, w, ep in zip(layers, weights, epilogues):
        kw = dict(stride=layer.S, padding=layer.Z, name=layer.name,
                  impl=impl)
        if fused:
            x = carla_conv(x, w, epilogue=ep, **kw)
        else:
            x = carla_conv(x, w, **kw)
            x = x * ep.scale + ep.bias
            if ep.residual is not None:
                x = x + ep.residual
            if ep.relu:
                x = torch.clamp_min(x, 0.0)
    return x


def collect_fused_delta(net: str, batch: int = 1, reps: int = 2,
                        smoke: bool = False, *, impl: str = "auto",
                        device="cuda") -> dict:
    """Measure each bottleneck block fused vs. unfused.

    Bytes are the spans' array footprints; the unfused side adds the
    round-trips of its separate element-wise passes (one read + one write
    of the output fmap per op, plus the scale/bias/residual operand reads).
    The fused side must come out strictly lower on every block — that is
    the whole point of the epilogue.  Times as ``run_network``'s, per
    block.
    """
    dev = resolve_device(device)
    flush = flush_buffer(dev) if dev.type == "cuda" else None
    layers = NET_LAYERS[net]()
    blocks_out = []
    for bi, (bname, blayers) in enumerate(_bottleneck_blocks(layers)):
        seed = 7_000 + 1_000 * bi
        first = blayers[0]
        x0 = _randn((batch, first.IL, first.IL, first.IC), seed, dev)
        weights, epilogues = [], []
        for li, layer in enumerate(blayers):
            weights.append(_layer_operands(layer, batch, seed + 10 * li,
                                           dev)[1])
            # residual on the block-closing layer (bottleneck shortcut add)
            ep = _layer_epilogue(layer, batch, seed + 100 + 10 * li, dev)
            if li != len(blayers) - 1 and ep.residual is not None:
                ep = Epilogue(scale=ep.scale, bias=ep.bias, relu=True)
            if li == len(blayers) - 1 and ep.residual is None \
                    and len(blayers) > 1:
                res = _randn((batch, layer.OL, layer.OL, layer.K), seed + 99,
                             dev)
                ep = Epilogue(scale=ep.scale, bias=ep.bias, relu=True,
                              residual=res)
            epilogues.append(ep)

        stats = {}
        for mode, fused in (("fused", True), ("unfused", False)):
            measured_s, spans, _ = _measure(
                lambda: _run_block(blayers, x0, weights, epilogues, fused,
                                   impl), reps, flush)
            byts = sum(s.attrs["bytes_touched"] for s in spans)
            if not fused:
                # the element-wise passes the fused flush absorbs: each one
                # reads and rewrites the full output fmap, plus its operands
                for layer, ep in zip(blayers, epilogues):
                    out_b = 4 * batch * layer.OL * layer.OL * layer.K  # fp32
                    byts += 2 * out_b * ep.n_fused_ops
                    byts += sum(a.numel() * a.element_size() for a in
                                (ep.scale, ep.bias, ep.residual)
                                if a is not None)
            stats[mode] = {"ms": measured_s * 1e3, "bytes": byts}

        blocks_out.append({
            "block": bname,
            "layers": len(blayers),
            "fused_ms": stats["fused"]["ms"],
            "unfused_ms": stats["unfused"]["ms"],
            "speedup": stats["unfused"]["ms"] / max(stats["fused"]["ms"], 1e-9),
            "fused_bytes_mb": stats["fused"]["bytes"] / 1e6,
            "unfused_bytes_mb": stats["unfused"]["bytes"] / 1e6,
            "saved_mb": (stats["unfused"]["bytes"]
                         - stats["fused"]["bytes"]) / 1e6,
            "analytic_saved_mb": sum(
                epilogue_dram_delta_bytes(
                    layer, scale_bias=True, relu=ep.relu,
                    residual=ep.residual is not None)
                for layer, ep in zip(blayers, epilogues)) / 1e6,
        })
    return {
        "blocks": blocks_out,
        "total_saved_mb": sum(b["saved_mb"] for b in blocks_out),
        "total_speedup": (sum(b["unfused_ms"] for b in blocks_out)
                          / max(sum(b["fused_ms"] for b in blocks_out), 1e-9)),
    }


def collect_sparse_delta(networks_rec: dict) -> dict:
    """Pair each ``<base>_sparse`` record with its dense ``<base>`` twin.

    Layers pair by name (the sparse layer tables reuse the dense names), so
    per layer the delta carries measured ms/bytes on both sides plus the
    keep-fraction the spans recorded.  ``check_regression`` holds the
    ``pruned`` entries to the invariant: strictly fewer bytes, and no
    slower than the dense twin beyond the band.
    """
    out: dict = {}
    for net, sn in networks_rec.items():
        if not net.endswith(SPARSE_SUFFIX):
            continue
        base = net[:-len(SPARSE_SUFFIX)]
        dn = networks_rec.get(base)
        if dn is None:
            continue
        dense = {l["layer"]: l for l in dn["layers"]}
        layers = []
        for sl in sn["layers"]:
            dl = dense.get(sl["layer"])
            if dl is None:
                continue
            layers.append({
                "layer": sl["layer"],
                "pruned": bool(sl.get("pruned", False)),
                "keep_fraction": sl.get("keep_fraction", 1.0),
                "dense_ms": dl["measured_ms"],
                "sparse_ms": sl["measured_ms"],
                "dense_bytes_mb": dl["bytes_mb"],
                "sparse_bytes_mb": sl["bytes_mb"],
                "saved_mb": dl["bytes_mb"] - sl["bytes_mb"],
                "speedup": dl["measured_ms"] / max(sl["measured_ms"], 1e-9),
            })
        pruned = [l for l in layers if l["pruned"]]
        out[base] = {
            "layers": layers,
            "pruned_layers": len(pruned),
            "total_dense_ms": sum(l["dense_ms"] for l in layers),
            "total_sparse_ms": sum(l["sparse_ms"] for l in layers),
            "total_saved_mb": sum(l["saved_mb"] for l in layers),
            "total_speedup": (sum(l["dense_ms"] for l in layers)
                              / max(sum(l["sparse_ms"] for l in layers),
                                    1e-9)),
        }
    return out


def collect_bench(nets: list[str], batch: int = 1, reps: int = REPS,
                  impl: str = "auto", smoke: bool = False,
                  tuned: bool = False, *, device="cuda") -> dict:
    """Measure the given layer sets and return the bench record.

    Per layer: measured ms (``run_network``), its host-clock ms, achieved
    GFLOP/s, utilization vs the run's best layer, bytes touched, plus the
    analytic side (ASIC ms, PUF) and the tuning and sparsity ledgers, as
    ``repro``'s version-4 record.  The record adds ``backend``, ``device``
    (the card's name and power limit), ``timer`` and per layer ``host_ms``.

    A net named ``<base>_fused`` measures ``<base>``'s layer set through
    the fused-epilogue path and its per-bottleneck-block fused-vs-unfused
    delta (``fused_delta``).  A net named ``<base>_sparse`` measures the
    structured-pruned twin of ``<base>``'s layer set; with the dense
    ``<base>`` in the same record, the per-layer delta lands under
    ``sparse_delta``.  ``tuned=True`` turns the tuning cache on for the
    measurement and adds, per dense net, every tuned key's tuned-vs-default
    device time (``launch.tune.collect_tuning_delta``; the card only).
    """
    dev = resolve_device(device)
    record: dict = {
        "version": 4,
        "backend": dev.type,
        "device": card(dev),
        "timer": timer_for(dev),
        "impl": impl,
        "batch": batch,
        "reps": reps,
        "smoke": smoke,
        "tuned": tuned,
        "kernel_hash": autotune.kernel_signature_hash(),
        "networks": {},
        "fused_delta": {},
        "sparse_delta": {},
        "tuning": {},
    }
    prev_enabled = autotune.enabled()
    if tuned:
        autotune.enable()
    try:
        for net in nets:
            fused = net.endswith(FUSED_SUFFIX)
            base = net[:-len(FUSED_SUFFIX)] if fused else net
            sparse = base.endswith(SPARSE_SUFFIX)
            if sparse:
                base = base[:-len(SPARSE_SUFFIX)]
                layers, tags = _sparsity_tags(base)
            else:
                layers, tags = NET_LAYERS[base](), None
            spans = run_network(layers, batch, reps, impl, fused=fused,
                                sparsity=tags, device=dev)
            rows = reconcile(spans)
            t = totals(rows)
            record["networks"][net] = {
                "total_measured_ms": t["measured_ms_per_image"],
                "total_host_ms": sum(s.attrs["host_ms"] for s in spans),
                "total_analytic_ms": t["analytic_ms"],
                "speed_ratio": t["speed_ratio"],
                "total_fused_saved_mb": t["fused_saved_mb"],
                "mac_keep_fraction": t["mac_keep_fraction"],
                "layers": [{
                    "layer": r.layer,
                    "dataflow": r.dataflow,
                    "measured_ms": r.measured_ms,
                    "host_ms": s.attrs["host_ms"],
                    "gflops": r.achieved_gflops,
                    "util_vs_peak": r.measured_util,
                    "analytic_ms": r.analytic_ms,
                    "analytic_puf": r.analytic_puf,
                    "epilogue": r.epilogue,
                    "bytes_mb": r.measured_bytes_mb,
                    "fused_saved_mb": r.fused_saved_mb,
                    "tile_util": r.tile_util,
                    "tuned": r.tuned,
                    "tile_config": r.tile_config,
                    "tuning_source": r.tuning_source,
                    "pruned": r.pruned,
                    "keep_fraction": r.keep_fraction,
                    "macs": r.macs,
                    "dense_twin_macs": r.dense_twin_macs,
                } for r, s in zip(rows, spans, strict=True)],
            }
            if fused:
                record["fused_delta"][base] = collect_fused_delta(
                    base, batch=batch, reps=reps, smoke=smoke, impl=impl,
                    device=dev)
            if tuned and net not in record["tuning"] and not fused:
                from ..launch.tune import collect_tuning_delta
                record["tuning"][net] = collect_tuning_delta(
                    base, reps=reps, layers=layers if sparse else None)
    finally:
        if tuned and not prev_enabled:
            autotune.disable()
    record["sparse_delta"] = collect_sparse_delta(record["networks"])
    return record


def measure_disabled_overhead(reps: int = 100, trials: int = 7, *,
                              device="cuda") -> tuple[float, float]:
    """Per-dispatch host time in microseconds: ``kernels.ops.conv2d`` with
    tracing disabled vs the kernel's own wrapper (its plain version on the
    CPU), each ``reps`` calls ending in a synchronise.

    Alternates instrumented/raw trials and keeps each side's minimum, so the
    comparison is robust to CPU frequency drift between the two measurements.
    """
    from ..kernels import conv2d as conv2d_mod
    from ..kernels import ops
    dev = resolve_device(device)
    x = torch.ones((1, 28, 28, 64), device=dev)
    w = torch.ones((3, 3, 64, 64), device=dev)
    raw_fn = conv2d_mod.conv2d if dev.type == "cuda" else \
        conv2d_mod.conv2d_plain
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x, w, stride=1, padding=1)
        sync()
        return (time.perf_counter() - t0) / reps * 1e6     # us

    trace.disable()
    ops.conv2d(x, w, stride=1, padding=1)                   # build once
    wrapped = min(timed(ops.conv2d) for _ in range(trials))
    raw = min(timed(raw_fn) for _ in range(trials))
    # interleave a second pass to wash out drift
    wrapped = min(wrapped, *(timed(ops.conv2d) for _ in range(trials)))
    raw = min(raw, *(timed(raw_fn) for _ in range(trials)))
    return wrapped, raw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", choices=["resnet50", "vgg16"], default="resnet50")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--limit", type=int, default=0,
                    help="only the first N layers (0 = all)")
    ap.add_argument("--impl", choices=["auto", "ref", "cuda"],
                    default="auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--fused", action="store_true",
                    help="dispatch each layer with a fused epilogue "
                         "(folded-BN scale/bias + ReLU; residual on "
                         "bottleneck-closing 1x1s)")
    ap.add_argument("--sparse", action="store_true",
                    help="run the structured-pruned twin of the layer set "
                         "(paper Table I); pruned dispatches are tagged with "
                         "their dense twin (keep%% column)")
    ap.add_argument("--peak-gflops", type=float, default=0.0,
                    help="peak for util%% (0 = best layer in run)")
    ap.add_argument("--json", default=None,
                    help="also export the measured spans to this path")
    ap.add_argument("--chrome", default=None,
                    help="export a chrome://tracing / Perfetto trace here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny layer set, 1 rep, no overhead check (seconds)")
    ap.add_argument("--skip-overhead", action="store_true")
    ap.add_argument("--tuned", action="store_true",
                    help="enable the tuning cache for the run (tile%%/tiles "
                         "columns show what ran)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.tuned:
        autotune.enable()

    if args.smoke:
        net, reps, skip_overhead = "smoke", 1, True
    else:
        net, reps, skip_overhead = args.net, args.reps, args.skip_overhead
    tags = None
    if args.sparse:
        layers, tags = _sparsity_tags(net)
        net = net + SPARSE_SUFFIX
    else:
        layers = NET_LAYERS[net]()
    if args.limit:
        layers = layers[:args.limit]

    print(f"=== {net}: analytic (ASIC @200 MHz, batch-1) vs measured "
          f"({dev.type}, {timer_for(dev)}, batch={args.batch}, "
          f"impl={args.impl}{', fused epilogue' if args.fused else ''}) ===")
    spans = run_network(layers, args.batch, reps, args.impl,
                        fused=args.fused, sparsity=tags, device=dev)
    rows = reconcile(spans, peak_gflops=args.peak_gflops or None)
    print(format_table(rows))

    t = totals(rows)
    print(f"\ntotals: {t['layers']} layers | analytic "
          f"{t['analytic_ms']:.1f} ms, {t['analytic_dram_mb']:.1f} DRAM MB | "
          f"measured {t['measured_ms_per_image']:.3f} ms/image, "
          f"{t['measured_bytes_mb']:.1f} MB arrays | "
          f"fused-epilogue HBM saved {t['fused_saved_mb']:.1f} MB | "
          f"measured/ASIC = {t['speed_ratio']:.4f}x | host clock "
          f"{sum(s.attrs['host_ms'] for s in spans):.3f} ms")
    if t["pruned_layers"]:
        print(f"structured sparsity: {t['pruned_layers']} pruned layers, "
              f"{t['mac_keep_fraction'] * 100:.1f}% of dense-twin MACs kept")
    by_mode: dict[str, int] = {}
    for r in rows:
        by_mode[r.dataflow] = by_mode.get(r.dataflow, 0) + 1
    print("modes: " + ", ".join(f"{k}={v}" for k, v in sorted(by_mode.items())))

    if args.json:
        with open(args.json, "w") as f:
            json.dump([s.to_dict() for s in spans], f, indent=2)
        print(f"trace -> {args.json}")

    if args.chrome:
        from ..observability.export import export_chrome_trace
        export_chrome_trace(spans, args.chrome)
        print(f"chrome trace -> {args.chrome} (open in ui.perfetto.dev)")

    if not skip_overhead:
        wrapped, raw = measure_disabled_overhead(device=dev)
        delta = wrapped - raw
        print(f"\ndisabled-tracing overhead: instrumented {wrapped:.1f} us vs "
              f"raw wrapper {raw:.1f} us per dispatch "
              f"(delta {delta:+.1f} us, {delta / raw * 100:+.1f}%)")


if __name__ == "__main__":
    main()
