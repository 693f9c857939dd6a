"""Tune the CNN kernels' plans per layer by measuring them on the card.

    PYTHONPATH=src python -m repro_torch.launch.tune --net resnet50 \\
        [--sparse] [--commit]

The port's counterpart of ``benchmarks/autotune.py``: for every unique
shape key (``core.autotune``) of a network's layer table — ``--sparse`` adds
its structured-sparse twin, whose pruned channel counts are new keys — it

  1. takes the candidate plans of ``core.autotune`` (every tile and split
     count the planner weighs, ranked by its latency model; for 1x1 layers
     both stationarities), the analytic plan among them;
  2. times each on the card with CUDA events from a cold L2 cache (before
     each call the stream sleeps and a 64 MB memset flushes the 50 MB L2, as
     ``chip_smoke.py`` times every kernel), in ``ROUNDS`` interleaved rounds;
  3. holds each candidate's output to the kernel's plain version on the same
     operands, within ``chip_smoke.py``'s tolerance (fp32 2e-4 x sqrt(R);
     bf16 max(2e-2 x sqrt(R), 2^-7 x max|plain|)); a candidate that misses
     it never wins (every candidate is a plan the launch takes; one it
     refused would raise);
  4. lets a candidate win only if its median beats the analytic plan's
     median by more than the run's spread (the analytic plan's max - min
     over its rounds); otherwise the entry records the analytic plan.  Each
     entry records ``tuned_ms`` and ``default_ms``.

By default the entries are merged into the user cache
(``autotune.cache_path()``); with ``--commit`` they are written to
``src/repro_torch/kernels/tuned/<net>.h100.json`` and the table document is
printed on stdout too.  A table carries the kernel hash of the sources it
was measured with and goes stale when any of them changes.

Layers are tuned as the main path runs them, at batch 1 in fp32, 1x1s at
their GEMM shape, with no epilogue (the keys' ``ep:none`` fallback covers
every epilogue, as in ``repro``).  The tuner runs on the card only: without
one it raises.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics

import torch

from ..core import autotune, networks
from ..core.autotune import Entry, TileConfig
from ..kernels import conv2d as _conv2d
from ..kernels import matmul as _mm
from ..models.convert import resolve_device

ROUNDS = 3          # interleaved timing rounds per candidate
REPS = 5            # cold calls averaged in one round
CANDIDATES = 6      # candidate plans timed per layer, the analytic one first
SLEEP_CYCLES = 1_000_000     # ~0.5 ms of device time at H100 clocks
FLUSH_BYTES = 64 * 2 ** 20   # more than the H100's 50 MB L2
NETS = ("resnet50", "vgg16", "smoke")


def net_layers(net: str, sparse: bool = False) -> list:
    """The conv layers of ``net`` (ResNet-50 with its projection shortcuts),
    then, with ``sparse``, its structured-sparse twin's."""
    tables = {"resnet50": lambda s: (networks.resnet50_conv_layers(s)
                                     + networks.resnet50_projection_shortcuts(
                                         s)),
              "vgg16": lambda s: networks.vgg16_conv_layers(),
              "smoke": networks.smoke_conv_layers}
    if net not in tables:
        raise KeyError(f"unknown net {net!r} (have {list(NETS)})")
    layers = tables[net](False)
    if sparse:
        if net not in networks.SPARSE_NETS:
            raise KeyError(f"no structured-sparse layer table for {net!r}")
        layers += tables[net](True)
    return layers


def gemm_rows(layer) -> int:
    """M of a 1x1 layer's GEMM at batch 1: the strided view's rows."""
    return (-(-layer.IL // layer.S)) ** 2


def layer_key(layer) -> str:
    """The layer's key at batch 1, fp32, no epilogue."""
    if layer.FL == 1:
        return autotune.gemm_key(gemm_rows(layer), layer.IC, layer.K,
                                 "float32")
    return autotune.conv2d_key((1, layer.IL, layer.IL, layer.IC),
                               (layer.FL, layer.FL, layer.IC, layer.K),
                               layer.S, layer.Z, "float32")


def candidates(layer, n_sms: int,
               max_candidates: int = CANDIDATES) -> list[TileConfig]:
    """The layer's candidate plans, the analytic one first."""
    if layer.FL == 1:
        return autotune.gemm_candidates(gemm_rows(layer), layer.IC, layer.K,
                                        n_sms=n_sms,
                                        max_candidates=max_candidates)
    return autotune.conv2d_candidates(
        (1, layer.IL, layer.IL, layer.IC),
        (layer.FL, layer.FL, layer.IC, layer.K), stride=layer.S,
        padding=layer.Z, n_sms=n_sms, max_candidates=max_candidates)


def cold_time_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Mean device time of fn() from a cold L2 cache: before each call the
    stream sleeps and then overwrites ``flush`` (more than the L2), and the
    host enqueues the events and the call while the device still sleeps,
    so the events time the device's work, not the host's launch."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


def tolerance(want: torch.Tensor, reduction: int) -> float:
    """``chip_smoke.py``'s kernel-vs-plain tolerance."""
    if want.dtype != torch.bfloat16:
        return 2e-4 * math.sqrt(reduction)
    return max(2e-2 * math.sqrt(reduction),
               2.0 ** -7 * want.float().abs().max().item())


def _operands(layer, gen):
    """(run(cfg), plain output, reduction length) of one layer on the card,
    fp32 operands at batch 1."""
    rn = lambda *s: torch.randn(s, device="cuda", generator=gen)
    if layer.FL == 1:
        x, w = rn(gemm_rows(layer), layer.IC), rn(layer.IC, layer.K)
        wrappers = {autotune.WS: _mm.matmul_weight_stationary,
                    autotune.AS: _mm.matmul_act_stationary}
        return ((lambda cfg: wrappers[cfg.stationarity](x, w, tiles=cfg)),
                _mm.matmul_plain(x, w), layer.IC)
    x = rn(1, layer.IL, layer.IL, layer.IC)
    w = rn(layer.FL, layer.FL, layer.IC, layer.K)
    kw = dict(stride=layer.S, padding=layer.Z)
    return ((lambda cfg: _conv2d.conv2d(x, w, tiles=cfg, **kw)),
            _conv2d.conv2d_plain(x, w, **kw), layer.FL ** 2 * layer.IC)


def tune_layer(layer, flush: torch.Tensor, gen: torch.Generator,
               log=None) -> tuple[Entry, list[dict]]:
    """Time every candidate of one layer; the entry and each candidate's
    record (config, per-round ms, error over tolerance, whether it passed
    its check)."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    run, want, reduction = _operands(layer, gen)
    tol = tolerance(want, reduction)
    recs = []
    for cfg in candidates(layer, n_sms):
        got = run(cfg)
        err = (got.float() - want.float()).abs().max().item()
        recs.append({"config": cfg, "short": cfg.short, "rounds": [],
                     "err_over_tol": err / tol,
                     "ok": err <= tol and bool(torch.isfinite(got).all())})
    analytic = recs[0]
    if not analytic["ok"]:
        raise RuntimeError(f"{layer.name}: the analytic plan "
                           f"{analytic['short']} fails its check: {analytic}")
    timed = [r for r in recs if r["ok"]]
    for _ in range(ROUNDS):
        for r in timed:
            r["rounds"].append(cold_time_ms(lambda: run(r["config"]), flush))
    best = choose(recs)
    entry = Entry(config=best["config"], source="cache",
                  tuned_ms=best["ms"], default_ms=analytic["ms"])
    if log:
        log(f"{layer.name:>22s}  default {analytic['ms']:8.4f} ms -> tuned "
            f"{best['ms']:8.4f} ms (spread {analytic['spread']:.4f})  "
            f"[{analytic['short']} -> {best['short']}]")
    return entry, recs


def choose(recs: list[dict]) -> dict:
    """The winner of one layer's timed candidate records (the analytic
    plan first): the fastest median among those that passed their check,
    if it beats the analytic plan's median by more than the spread of the
    analytic plan's rounds; else the analytic plan.  Sets each timed
    record's ``ms`` (median) and the analytic one's ``spread``."""
    timed = [r for r in recs if r["ok"]]
    for r in timed:
        r["ms"] = statistics.median(r["rounds"])
    analytic = recs[0]
    analytic["spread"] = max(analytic["rounds"]) - min(analytic["rounds"])
    best = min(timed, key=lambda r: r["ms"])
    return best if best["ms"] < analytic["ms"] - analytic["spread"] \
        else analytic


def tune_layers(layers, *, seed: int = 0,
                log=None) -> tuple[dict[str, Entry], dict[str, list]]:
    """Tune every unique key of ``layers``: (entries, candidate records),
    operands drawn from ``seed``."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    entries, records = {}, {}
    for layer in layers:
        key = layer_key(layer)
        if key not in entries:
            entries[key], records[key] = tune_layer(layer, flush, gen, log)
    return entries, records


def table_name(net: str) -> str:
    """``<net>.h100.json`` on an H100, else ``<net>.<device slug>.json``."""
    name = autotune.device_name()
    card = "h100" if "H100" in name else "".join(
        ch if ch.isalnum() else "-" for ch in name.lower())
    return f"{net}.{card}.json"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", choices=NETS, default="resnet50")
    ap.add_argument("--sparse", action="store_true",
                    help="add the structured-sparse twin's layers")
    ap.add_argument("--commit", action="store_true",
                    help="write src/repro_torch/kernels/tuned/<net>.h100.json "
                         "(and print it) instead of the user cache")
    args = ap.parse_args(argv)
    resolve_device("cuda")

    entries, records = tune_layers(net_layers(args.net, args.sparse),
                                   log=print)
    changed = sum(e.config != records[k][0]["config"]
                  for k, e in entries.items())
    if args.commit:
        path = os.path.join(autotune.tables_dir(), table_name(args.net))
        doc = autotune.table_doc(entries, net=args.net)
        autotune.write_table(path, doc)
        print(json.dumps(doc))
    else:
        path = autotune.save_user_cache(entries)
    print(f"{len(entries)} keys, {changed} off the analytic plan -> {path}")
    return entries


if __name__ == "__main__":
    main()
