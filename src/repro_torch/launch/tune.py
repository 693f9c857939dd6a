"""Tune the CNN kernels' plans per layer by measuring them on the card.

    PYTHONPATH=src python -m repro_torch.launch.tune --net resnet50 \\
        [--batch 1] [--reps 5] [--candidates 6] [--sparse] [--smoke] \\
        [--commit | --out table.json] [--verbose]

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
printed on stdout too; ``--out PATH`` writes the table there instead of
either.  A table carries the kernel hash of the sources it was measured
with and goes stale when any of them changes.

Layers are tuned as the main path runs them, in fp32, 1x1s at their GEMM
shape, with no epilogue (the keys' ``ep:none`` fallback covers every
epilogue, as in ``repro``), at ``--batch`` images (default 1): the
dispatch looks plans up by the real batch (``conv2d|x{b}x...``,
``gemm|m{b * rows}...``), so a network served at batch 8 needs keys tuned at
batch 8.  The options are ``benchmarks/autotune.py``'s: ``--reps`` cold
calls a round (``REPS``), ``--candidates`` plans timed per key, the
analytic one first (``CANDIDATES``), ``--smoke`` the smoke layer set on the
least budget (1 call a round, at most 3 candidates), ``--verbose`` every
candidate's rounds, not only the winners.  The tuner runs on the card only:
without one it raises.
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


def gemm_rows(layer, batch: int = 1) -> int:
    """M of a 1x1 layer's GEMM at ``batch`` images: the strided view's
    rows."""
    return batch * (-(-layer.IL // layer.S)) ** 2


def layer_key(layer, batch: int = 1) -> str:
    """The layer's key at ``batch`` images, fp32, no epilogue."""
    if layer.FL == 1:
        return autotune.gemm_key(gemm_rows(layer, batch), layer.IC, layer.K,
                                 "float32")
    return autotune.conv2d_key((batch, layer.IL, layer.IL, layer.IC),
                               (layer.FL, layer.FL, layer.IC, layer.K),
                               layer.S, layer.Z, "float32")


def candidates(layer, n_sms: int, max_candidates: int = CANDIDATES,
               batch: int = 1) -> list[TileConfig]:
    """The layer's candidate plans at ``batch`` images, the analytic one
    first."""
    if layer.FL == 1:
        return autotune.gemm_candidates(gemm_rows(layer, batch), layer.IC,
                                        layer.K, n_sms=n_sms,
                                        max_candidates=max_candidates)
    return autotune.conv2d_candidates(
        (batch, layer.IL, layer.IL, layer.IC),
        (layer.FL, layer.FL, layer.IC, layer.K), stride=layer.S,
        padding=layer.Z, n_sms=n_sms, max_candidates=max_candidates)


def tolerance(want: torch.Tensor, reduction: int) -> float:
    """``chip_smoke.py``'s kernel-vs-plain tolerance."""
    if want.dtype != torch.bfloat16:
        return 2e-4 * math.sqrt(reduction)
    return max(2e-2 * math.sqrt(reduction),
               2.0 ** -7 * want.float().abs().max().item())


def _operands(layer, gen, batch: int = 1):
    """(run(cfg), plain output, reduction length) of one layer on the card,
    fp32 operands at ``batch`` images."""
    rn = lambda *s: torch.randn(s, device="cuda", generator=gen)
    if layer.FL == 1:
        x, w = rn(gemm_rows(layer, batch), layer.IC), rn(layer.IC, layer.K)
        # the dispatch's decision: the candidate's stationarity's route
        return ((lambda cfg: _mm.matmul(x, w, tiles=cfg)),
                _mm.matmul_plain(x, w), layer.IC)
    x = rn(batch, layer.IL, layer.IL, layer.IC)
    w = rn(layer.FL, layer.FL, layer.IC, layer.K)
    kw = dict(stride=layer.S, padding=layer.Z)
    return ((lambda cfg: _conv2d.conv2d(x, w, tiles=cfg, **kw)),
            _conv2d.conv2d_plain(x, w, **kw), layer.FL ** 2 * layer.IC)


def tune_layer(layer, flush: torch.Tensor, gen: torch.Generator,
               log=None, *, batch: int = 1, reps: int = REPS,
               max_candidates: int = CANDIDATES,
               verbose: bool = False) -> tuple[Entry, list[dict]]:
    """Time every candidate of one layer at ``batch`` images, ``reps``
    cold calls a round; the entry and each candidate's record (config,
    per-round ms, error over tolerance, whether it passed its check)."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    run, want, reduction = _operands(layer, gen, batch)
    tol = tolerance(want, reduction)
    recs = []
    for cfg in candidates(layer, n_sms, max_candidates, batch):
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
                                            reps))
    best = choose(recs)
    if log and verbose:
        for r in recs:
            log(f"  {layer_key(layer, batch)}  {r['short']:<24s} "
                + (" ".join(f"{ms:8.4f}" for ms in r["rounds"]) + " ms"
                   if r["ok"] else f"failed its check "
                                   f"(err / tol {r['err_over_tol']:.3g})"))
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


def tune_layers(layers, *, batch: int = 1, reps: int = REPS,
                max_candidates: int = CANDIDATES, seed: int = 0, log=None,
                verbose: bool = False
                ) -> tuple[dict[str, Entry], dict[str, list]]:
    """Tune every unique key of ``layers`` at ``batch`` images: (entries,
    candidate records), operands drawn from ``seed``, ``reps`` cold calls a
    round, at most ``max_candidates`` plans a key."""
    flush = flush_buffer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    entries, records = {}, {}
    for layer in layers:
        key = layer_key(layer, batch)
        if key not in entries:
            entries[key], records[key] = tune_layer(
                layer, flush, gen, log, batch=batch, reps=reps,
                max_candidates=max_candidates, verbose=verbose)
    return entries, records


def collect_tuning_delta(net: str, *, batch: int = 1, reps: int = REPS,
                         layers=None, seed: int = 3) -> dict:
    """Tuned against default plan, per unique key of ``net``'s layers
    (``layers`` overrides them, e.g. the structured-sparse twin's) at
    ``batch`` images: for each
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
        key = layer_key(layer, batch)
        if key in seen:
            continue
        seen.add(key)
        entry = autotune.lookup(key)
        if entry is None:
            out.append({"layer": layer.name, "key": key, "tuned": False})
            continue
        run, _, _ = _operands(layer, gen, batch)
        default = candidates(layer, n_sms, max_candidates=1, batch=batch)[0]
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
    ap.add_argument("--batch", type=int, default=1,
                    help="images per call the keys are tuned at")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="cold calls timed per round")
    ap.add_argument("--candidates", type=int, default=CANDIDATES,
                    help="most candidate plans timed per key")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke layer set on the least budget (1 call a "
                         "round, at most 3 candidates)")
    ap.add_argument("--sparse", action="store_true",
                    help="add the structured-sparse twin's layers")
    ap.add_argument("--commit", action="store_true",
                    help="write src/repro_torch/kernels/tuned/<net>.h100.json "
                         "(and print it) instead of the user cache")
    ap.add_argument("--out", default=None,
                    help="write the table to this path (over --commit and "
                         "the user cache)")
    ap.add_argument("--verbose", action="store_true",
                    help="print every candidate's rounds, not only the "
                         "winners")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.reps < 1 or args.candidates < 1:
        ap.error("--batch, --reps and --candidates take positive counts")
    net = "smoke" if args.smoke else args.net
    reps = 1 if args.smoke else args.reps
    cands = min(args.candidates, 3) if args.smoke else args.candidates
    resolve_device("cuda")

    layers = net_layers(net, args.sparse)
    print(f"tune {net}: {len(layers)} layers, batch {args.batch}, {reps} "
          f"calls a round, <= {cands} candidates a key")
    entries, records = tune_layers(layers, batch=args.batch, reps=reps,
                                   max_candidates=cands, log=print,
                                   verbose=args.verbose)
    changed = sum(e.config != records[k][0]["config"]
                  for k, e in entries.items())
    if args.out or args.commit:
        path = args.out or os.path.join(autotune.tables_dir(),
                                        table_name(net))
        doc = autotune.table_doc(entries, net=net)
        autotune.write_table(path, doc)
        if args.commit and not args.out:
            print(json.dumps(doc))
    else:
        path = autotune.save_user_cache(entries)
    print(f"{len(entries)} keys, {changed} off the analytic plan -> {path}")
    return entries


if __name__ == "__main__":
    main()
