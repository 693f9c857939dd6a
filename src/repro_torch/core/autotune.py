"""Empirical per-layer tuning cache — the CUDA kernels' plans, keyed by shape.

CARLA's controller reconfigures the dataflow per layer so PE utilization stays
near 98% across every shape of ResNet-50/VGG-16 (paper §III).  The software
twin reproduces the *selection rule* analytically (``core.modes``), and the
pipelined CUDA kernels (conv2d and both 1x1 GEMMs, ``csrc/gemm_pipe.cuh``)
take a plan the ASIC does not have: a block tile and a split of the
reduction, picked by a latency model fitted to one sweep
(``kernels._build.plan_gemm``/``plan_weight_stationary``).  The best plan is
an empirical property of the card, not of the rule.  This module is the
persistence + lookup layer for a per-layer operating point chosen by
measurement (the port of ``repro.core.autotune`` over the port's own plan
space):

  * **Key**: ``(op kind, layer shape, dtype, epilogue signature)`` rendered as
    a flat string, the same string as ``repro``'s, so a key names the same
    layer in both packages.  1x1 convs flatten to their GEMM shape so
    ``conv1x1`` and ``gemm`` share entries.
  * **Entry**: the winning :class:`TileConfig` — the tile code and split count
    plus, for GEMM shapes, the stationarity (dataflow) choice itself — with
    the measured tuned/default device times and where the entry came from
    (``table`` = committed, ``cache`` = user cache dir, ``runtime`` =
    injected in-process).
  * **Invalidation**: every table records ``kernel_signature_hash()``, the
    hash of the tunable kernels' sources and headers (``TUNED_SOURCES``)
    and the compiler flags.  Entries whose hash no longer matches
    are ignored, and committed tables that went stale are reported by
    :func:`stale_tables`.  A table whose header names another backend or
    device is skipped.
  * **Overhead contract**: ``enabled()`` is one module-attribute read; a
    lookup is one or two dict hits, made by :func:`decide` alone, once a
    dispatch, and only with tuning enabled (off by default).
  * **Generation**: ``generation()`` counts the changes of the live cache
    (a load of the tables, :func:`put`, :func:`reset`); a forward replayed
    from a CUDA graph (``models.cnn_graph``) keys on it, so a plan that a
    change of the cache would alter is never replayed.

The search itself lives in ``launch/tune.py``; this module defines keys,
the cache, the one decision of a dispatch (:func:`decide`: route,
stationarity and tuning entry, which the launch, both spans and the
candidates read), candidate generation (ranked by the planner's latency
model), and the ``tile_util`` padding-waste metric (logical FLOPs / FLOPs
of the padded tiles, the analogue of the paper's PUF).

Sources, highest precedence first:
  1. runtime entries injected via :func:`put` (tests, notebooks);
  2. the user cache dir (``~/.cache/repro-torch-autotune`` or
     ``$REPRO_TORCH_AUTOTUNE_CACHE``), written by ``launch/tune.py``;
  3. committed tables under ``src/repro_torch/kernels/tuned/`` (or
     ``$REPRO_TORCH_TUNED_TABLES_DIR``), written with ``--commit``.

Enable with :func:`enable` or ``REPRO_TORCH_AUTOTUNE=1``; the names differ
from ``repro``'s so that enabling one package never enables the other.
"""
from __future__ import annotations

import json
import os
import subprocess
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..kernels import _build
from .modes import Stationarity, select_stationarity

WS = Stationarity.WEIGHT_STATIONARY.value
AS = Stationarity.ACTIVATION_STATIONARY.value


# ---------------------------------------------------------------------------
# Tile configurations
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TileConfig:
    """One operating point of a pipelined launch: the block tile (an index
    into ``_build.PIPE_TILES``), the splits of the reduction, and for GEMM
    shapes the stationarity.  Frozen and hashable.  Where a layer has no
    entry (``None`` in its place) the analytic planner decides."""

    tile: int
    splits: int
    stationarity: str | None = None   # modes.Stationarity.value, or None

    @property
    def short(self) -> str:
        """Compact span-attribute label, e.g. ``"64x64g4/s6/ws"``."""
        bm, bn, g = _build.PIPE_TILES[self.tile]
        label = f"{bm}x{bn}g{g}/s{self.splits}"
        if self.stationarity:
            label += "/ws" if self.stationarity == WS else "/as"
        return label

    def to_dict(self) -> dict:
        d = {"tile": self.tile, "splits": self.splits}
        if self.stationarity:
            d["stationarity"] = self.stationarity
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TileConfig":
        return cls(tile=int(d["tile"]), splits=int(d["splits"]),
                   stationarity=d.get("stationarity"))


@dataclass(frozen=True)
class Entry:
    """A cache hit: the winning config and the measurements behind it."""

    config: TileConfig
    source: str = "runtime"        # "table" | "cache" | "runtime"
    tuned_ms: float = 0.0
    default_ms: float = 0.0


# ---------------------------------------------------------------------------
# Keys (the strings of repro.core.autotune)
# ---------------------------------------------------------------------------
def conv2d_key(x_shape, w_shape, stride: int, padding: int, dtype,
               epilogue: str = "none") -> str:
    b, h, w, c = x_shape
    fh, fw, _, k = w_shape
    return (f"conv2d|x{b}x{h}x{w}x{c}|f{fh}x{fw}x{k}|s{stride}p{padding}"
            f"|{dtype}|ep:{epilogue}")


def gemm_key(m: int, c: int, k: int, dtype, epilogue: str = "none") -> str:
    return f"gemm|m{m}|c{c}|k{k}|{dtype}|ep:{epilogue}"


def _ep_none(key: str) -> str:
    """The epilogue-agnostic fallback key (the plan barely depends on it)."""
    return key[:key.rindex("|ep:")] + "|ep:none"


# ---------------------------------------------------------------------------
# Kernel-signature hash, the device, and where tables live
# ---------------------------------------------------------------------------
_TUNED_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "tuned")


# What a tuned plan depends on: the tunable CNN kernels' sources and the
# headers they include (``gemm_pipe.cuh`` includes ``numeric.cuh`` and
# ``ptx.cuh``), as ``repro`` hashes only ``conv2d.py`` and ``matmul.py``.
TUNED_SOURCES = ("conv2d.cu", "matmul.cu", "gemm_pipe.cuh", "numeric.cuh",
                 "ptx.cuh")


def kernel_signature_hash() -> str:
    """Hash of the tunable kernels' sources and the nvcc flags; tables carry
    it, loaders check it.  An edit of another kernel leaves it as it is."""
    return _build.source_hash(TUNED_SOURCES)


def backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def device_name() -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it, or ``not
    measured``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def tables_dir() -> str:
    """Committed tuned tables (env-overridable for tests)."""
    return os.environ.get("REPRO_TORCH_TUNED_TABLES_DIR", _TUNED_DIR)


def cache_dir() -> str:
    """User tuning cache (env-overridable)."""
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "repro-torch-autotune"))


def cache_path() -> str:
    return os.path.join(cache_dir(), f"cache.{backend()}.json")


# ---------------------------------------------------------------------------
# Cache state
# ---------------------------------------------------------------------------
class _State:
    def __init__(self) -> None:
        self.entries: dict[str, Entry] = {}
        self.stale_tables: list[dict] = []   # committed tables w/ bad hash


_state: _State | None = None
_enabled = os.environ.get("REPRO_TORCH_AUTOTUNE", "") not in ("", "0", "off")
_generation = 0


def generation() -> int:
    """How many times the live cache has changed: loaded from the tables,
    written by :func:`put` or dropped by :func:`reset`."""
    return _generation


def _changed() -> None:
    global _generation
    _generation += 1


def enabled() -> bool:
    """The hot-path gate: one module-attribute read, nothing else."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop the in-memory cache; the next lookup reloads from disk."""
    global _state
    _state = None
    _changed()


def _load_table(path: str, source: str, state: _State, cur_hash: str,
                where: tuple[str, str]) -> None:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    if (doc.get("backend"), doc.get("device")) != where:
        return
    if doc.get("kernel_hash") != cur_hash:
        if source == "table":
            state.stale_tables.append(
                {"path": path, "table_hash": doc.get("kernel_hash"),
                 "current_hash": cur_hash})
        return
    for key, e in doc.get("entries", {}).items():
        # user cache outranks committed tables; runtime puts outrank both
        # (load order is table -> cache; put() happens after).
        state.entries[key] = Entry(
            config=TileConfig.from_dict(e["config"]), source=source,
            tuned_ms=e.get("tuned_ms", 0.0),
            default_ms=e.get("default_ms", 0.0))


def _ensure() -> _State:
    global _state
    if _state is None:
        st = _State()
        cur, where = kernel_signature_hash(), (backend(), device_name())
        tdir = tables_dir()
        if os.path.isdir(tdir):
            for name in sorted(os.listdir(tdir)):
                if name.endswith(".json"):
                    _load_table(os.path.join(tdir, name), "table", st, cur,
                                where)
        if os.path.exists(cache_path()):
            _load_table(cache_path(), "cache", st, cur, where)
        _state = st
        _changed()
    return _state


def lookup(key: str) -> Entry | None:
    """O(1): exact key, then the epilogue-agnostic fallback."""
    entries = _ensure().entries
    hit = entries.get(key)
    if hit is None and not key.endswith("|ep:none"):
        hit = entries.get(_ep_none(key))
    return hit


def lookup_conv2d(x_shape, w_shape, stride, padding, dtype,
                  epilogue: str = "none") -> Entry | None:
    return lookup(conv2d_key(x_shape, w_shape, stride, padding, dtype,
                             epilogue))


def lookup_gemm(m, c, k, dtype, epilogue: str = "none") -> Entry | None:
    return lookup(gemm_key(m, c, k, dtype, epilogue))


def put(key: str, config: TileConfig, *, source: str = "runtime",
        tuned_ms: float = 0.0, default_ms: float = 0.0) -> Entry:
    """Inject/overwrite an entry in the live cache (no disk write)."""
    e = Entry(config, source, tuned_ms, default_ms)
    _ensure().entries[key] = e
    _changed()
    return e


def stale_tables() -> list[dict]:
    """Committed tables whose kernel hash no longer matches the sources."""
    return list(_ensure().stale_tables)


# ---------------------------------------------------------------------------
# Persistence (the tuner writes through these)
# ---------------------------------------------------------------------------
def table_doc(entries: dict[str, Entry], *, net: str | None = None) -> dict:
    return {
        "version": 1,
        "backend": backend(),
        "device": device_name(),
        "power_limit": power_limit() if backend() == "cuda" else None,
        "impl": "cuda",
        "net": net,
        "kernel_hash": kernel_signature_hash(),
        "entries": {
            key: {"config": e.config.to_dict(), "tuned_ms": e.tuned_ms,
                  "default_ms": e.default_ms}
            for key, e in sorted(entries.items())},
    }


def write_table(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def save_user_cache(entries: dict[str, Entry]) -> str:
    """Merge ``entries`` into the user cache file; returns its path."""
    path = cache_path()
    merged: dict[str, Entry] = {}
    if os.path.exists(path):
        st = _State()
        _load_table(path, "cache", st, kernel_signature_hash(),
                    (backend(), device_name()))
        merged.update(st.entries)
    merged.update(entries)
    write_table(path, table_doc(merged))
    reset()
    return path


# ---------------------------------------------------------------------------
# The decision: what one dispatch runs, made once
# ---------------------------------------------------------------------------
CONV2D, MM_AS, MM_WS = "conv2d", "mm_act_stationary", "mm_weight_stationary"
DWCONV = "dwconv"
GEMM_ROUTES = {Stationarity.ACTIVATION_STATIONARY: MM_AS,
               Stationarity.WEIGHT_STATIONARY: MM_WS}


class Decision(NamedTuple):
    """What a pipelined dispatch runs: the route (a key of
    ``_build.ROUTES``), a GEMM's stationarity (None on the conv kernel),
    the tuning cache's hit, the tiles the launch takes (the hit's or the
    caller's; None: the route's planner plans) and the implicit GEMM's
    rows, columns and reduction."""

    route: str
    stationarity: Stationarity | None
    entry: Entry | None
    tiles: TileConfig | None
    rows: int
    cols: int
    reduction: int


def is_depthwise(x_shape, w_shape) -> bool:
    """Whether a (k, k, 1, C) filter on x of C > 1 channels is depthwise:
    one filter a channel (with C = 1 the two readings are one conv)."""
    return (len(w_shape) == 4 and w_shape[2] == 1 and w_shape[3] > 1
            and x_shape[-1] == w_shape[3])


def decide(x_shape, w_shape, stride: int = 1, padding: int = 0,
           dtype: str = "float32", epilogue: str = "none", *,
           stationarity: Stationarity | None = None,
           tiles: TileConfig | None = None, cache: bool = True) -> Decision:
    """The one decision of a conv or GEMM dispatch.

    A depthwise (k, k, 1, C) filter (``is_depthwise``) takes the depthwise
    kernel, which has no plan to tune: its rows are the output pixels, its
    columns the channels, its reduction the k*k taps.  Any other (FH, FW,
    C, K) filter takes the conv kernel; a (C, K) one the 1x1 GEMM on x
    (M, C), or NHWC read at ``stride``.  With ``cache`` and tuning enabled
    the cache is read, once: a hit's tiles replace ``tiles``.  A GEMM's
    stationarity is ``stationarity`` where given, else the tiles', else the
    controller's rule on the rows (``modes.select_stationarity``)."""
    if is_depthwise(x_shape, w_shape):
        b, h, wd, c = x_shape
        k = w_shape[0]
        oh, ow = _build.out_hw(h, wd, k, k, stride, padding)
        return Decision(DWCONV, None, None, None, b * oh * ow, c, k * k)
    m, n, r = _build.pipe_dims(x_shape, w_shape, stride, padding)
    gemm = len(w_shape) == 2
    entry = None
    if cache and _enabled:
        entry = (lookup_gemm(m, r, n, dtype, epilogue) if gemm else
                 lookup_conv2d(x_shape, w_shape, stride, padding, dtype,
                               epilogue))
        if entry is not None:
            tiles = entry.config
    if not gemm:
        return Decision(CONV2D, None, entry, tiles, m, n, r)
    if stationarity is None:
        stationarity = (Stationarity(tiles.stationarity)
                        if tiles is not None and tiles.stationarity
                        else select_stationarity(m))
    return Decision(GEMM_ROUTES[stationarity], stationarity, entry, tiles,
                    m, n, r)


def launch_plan(d: Decision, x, w, residual=None,
                n_sms: int | None = None) -> _build.GemmPlan:
    """The plan the launch of ``d`` takes on these operands (on x's device,
    or a card of ``n_sms`` SMs): ``d``'s tiles, else its route's planner's;
    the vec16 path where the operands allow it."""
    if n_sms is None and d.tiles is None:
        n_sms = _build.sm_count(x.device)
    return _build.route_plan(
        d.route, d.rows, d.cols, d.reduction, n_sms,
        _build.vec_path(x.shape[-1], d.cols, x, w, residual), d.tiles)


def reference_plan(d: Decision, c: int,
                   tiles: TileConfig | None = None) -> _build.GemmPlan:
    """``d``'s plan on an H100 (``REFERENCE_SMS``), on the vec16 path where
    the C input channels allow it: ``tiles``', else the route's planner's.
    ``tile_util`` describes it where nothing launched; None on a route with
    no GEMM plan (the depthwise conv)."""
    if _build.ROUTES[d.route].planner is None:
        return None
    return _build.route_plan(d.route, d.rows, d.cols, d.reduction,
                             _build.REFERENCE_SMS, c % _build.PIPE_BK == 0,
                             tiles)


# ---------------------------------------------------------------------------
# Candidates: the plans the launch takes, ranked by the latency model
# ---------------------------------------------------------------------------
def conv2d_shape(x_shape, w_shape, stride: int = 1,
                 padding: int = 0) -> tuple[int, int, int, bool]:
    """(M, N, reduction, vec16 path allowed by C) of the implicit GEMM."""
    return (*_build.pipe_dims(x_shape, w_shape, stride, padding),
            x_shape[-1] % _build.PIPE_BK == 0)


def _ranked(m: int, n: int, reduction: int, vec: bool,
            n_sms: int) -> list[_build.GemmPlan]:
    return sorted(_build.pipe_plans(reduction, vec,
                                    range(len(_build.PIPE_TILES))),
                  key=lambda p: _build.pipe_cycles(m, n, p, n_sms))


def conv2d_candidates(x_shape, w_shape, *, stride: int = 1, padding: int = 0,
                      n_sms: int = _build.REFERENCE_SMS,
                      max_candidates: int = 6) -> list[TileConfig]:
    """Plans of the conv kernel: every (tile, splits) the planner would
    weigh, ranked by its modelled time, the first ``max_candidates``; the
    analytic plan is always the first."""
    m, n, r, vec = conv2d_shape(x_shape, w_shape, stride, padding)
    analytic = _build.route_plan(CONV2D, m, n, r, n_sms, vec)
    out = [TileConfig(analytic.tile, analytic.splits)]
    for p in _ranked(m, n, r, vec, n_sms):
        cfg = TileConfig(p.tile, p.splits)
        if cfg not in out:
            out.append(cfg)
    return out[:max_candidates]


def gemm_candidates(m: int, c: int, k: int, *,
                    n_sms: int = _build.REFERENCE_SMS,
                    max_candidates: int = 8) -> list[TileConfig]:
    """Plans of the dual-stationarity GEMM, tiles AND the dataflow.

    First the analytic plan (the untuned decision's stationarity and its
    route's plan), then the other stationarity's, then every other (tile,
    splits) either planner would weigh, ranked by the modelled time and
    labelled with the analytic stationarity where its planner may take the
    tile; the first ``max_candidates``.
    """
    vec = c % _build.PIPE_BK == 0
    st = decide((m, c), (c, k), cache=False).stationarity
    other = next(s for s in GEMM_ROUTES if s != st)
    out = []
    for s in (st, other):
        p = _build.route_plan(GEMM_ROUTES[s], m, k, c, n_sms, vec)
        out.append(TileConfig(p.tile, p.splits, s.value))
    ws = _build.ws_codes(m)
    for p in _ranked(m, k, c, vec, n_sms):
        label = st.value if (st.value == AS or p.tile in ws) else AS
        if all((q.tile, q.splits) != (p.tile, p.splits) for q in out):
            out.append(TileConfig(p.tile, p.splits, label))
    return out[:max_candidates]


# ---------------------------------------------------------------------------
# tile_util — padding waste, the analogue of the paper's PUF
# ---------------------------------------------------------------------------
def tile_util(d: Decision, plan: _build.GemmPlan | None) -> float:
    """Logical FLOPs / FLOPs of the padded tiles ``plan`` runs for ``d``
    (1.0 for a route with no GEMM plan)."""
    m, n, r = d.rows, d.cols, d.reduction
    if m * n * r == 0 or plan is None:
        return 1.0
    up = lambda v, t: -(-v // t) * t
    return (m * n * r) / (up(m, plan.bm) * up(n, plan.bn)
                          * up(r, _build.PIPE_BK))


def tile_util_conv2d(x_shape, w_shape, stride: int = 1, padding: int = 0,
                     tiles: TileConfig | None = None) -> float:
    """``tile_util`` of the conv kernel's plan on an H100 (the vec16 path
    where C allows it): the tuned tile, or the analytic plan's."""
    d = decide(x_shape, w_shape, stride, padding, tiles=tiles, cache=False)
    return tile_util(d, reference_plan(d, x_shape[-1], tiles))


def tile_util_gemm(m: int, c: int, k: int,
                   tiles: TileConfig | None = None,
                   stationarity: str | None = None) -> float:
    """``tile_util`` of the GEMM's plan on an H100 under ``stationarity``
    (else the decision's): the tuned tile, or the route's analytic plan."""
    d = decide((m, c), (c, k), tiles=tiles, cache=False,
               stationarity=Stationarity(stationarity) if stationarity
               else None)
    return tile_util(d, reference_plan(d, c, tiles))
