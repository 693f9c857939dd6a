"""Tune the CNN kernels' plans per layer by measuring them on the card.

    PYTHONPATH=src python -m repro_torch.launch.tune --net resnet50 \\
        [--sparse] [--commit]

The port's counterpart of ``benchmarks/autotune.py``: for every unique
shape key (``core.autotune``) of a network's layer table — ``--sparse`` adds
its structured-sparse twin, whose pruned channel counts are new keys — it

  1. takes the candidate plans of ``core.autotune`` (every tile and split
     count the planner weighs, ranked by its latency model; for 1x1 layers
     both stationarities), the analytic plan among them;
  2. times each on the card with CUDA events from a cold L2 cache
     (``bench.timer``, the timer of ``chip_smoke.py`` and the bench
     record), in ``ROUNDS`` interleaved rounds;
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

from ..bench.timer import cold_time_ms, cold_times_ms, flush_buffer
from ..core import autotune, networks
from ..core.autotune import Entry, TileConfig
from ..kernels import conv2d as _conv2d
from ..kernels import matmul as _mm
from ..models.convert import resolve_device

ROUNDS = 3          # interleaved timing rounds per candidate
REPS = 5            # cold calls averaged in one round (timed per plan by
                    # collect_tuning_delta)
CANDIDATES = 6      # candidate plans timed per layer, the analytic one first
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
            r["rounds"].append(cold_time_ms(lambda: run(r["config"]), flush,
                                            REPS))
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
    flush = flush_buffer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    entries, records = {}, {}
    for layer in layers:
        key = layer_key(layer)
        if key not in entries:
            entries[key], records[key] = tune_layer(layer, flush, gen, log)
    return entries, records


def collect_tuning_delta(net: str, *, reps: int = REPS, layers=None,
                         seed: int = 3) -> dict:
    """Tuned against default plan, per unique key of ``net``'s layers
    (``layers`` overrides them, e.g. the structured-sparse twin's): for each
    key the tuning cache resolves (committed tables and the user cache),
    the median cold-L2 device time of ``reps`` calls under its tuned plan
    and under the analytic plan, on operands drawn from ``seed``; a key
    with no entry is listed untimed, so a gap in the tables shows.  The
    section ``bench.check_regression.check_tuning`` gates on.  Needs the
    card: without one it raises."""
    resolve_device("cuda")
    if layers is None:
        layers = net_layers(net)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = flush_buffer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    seen, out = set(), []
    for layer in layers:
        key = layer_key(layer)
        if key in seen:
            continue
        seen.add(key)
        entry = autotune.lookup(key)
        if entry is None:
            out.append({"layer": layer.name, "key": key, "tuned": False})
            continue
        run, _, _ = _operands(layer, gen)
        default = candidates(layer, n_sms, max_candidates=1)[0]
        time_ms = lambda cfg: statistics.median(
            cold_times_ms(lambda: run(cfg), flush, reps))
        default_ms, tuned_ms = time_ms(default), time_ms(entry.config)
        out.append({
            "layer": layer.name, "key": key, "tuned": True,
            "tile_config": entry.config.short,
            "tuning_source": entry.source,
            "default_ms": default_ms, "tuned_ms": tuned_ms,
            "speedup": default_ms / max(tuned_ms, 1e-9)})
    timed = [e for e in out if e["tuned"]]
    return {"impl": "cuda", "timer": "cuda_event_cold_l2", "layers": out,
            "keys_timed": len(timed), "keys_missing": len(out) - len(timed),
            "total_default_ms": sum(e["default_ms"] for e in timed),
            "total_tuned_ms": sum(e["tuned_ms"] for e in timed)}


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
