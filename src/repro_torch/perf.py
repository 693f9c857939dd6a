"""Beyond-paper performance flags (the §Perf hillclimb knobs); a copy of
``repro.perf``.

The paper-faithful baseline runs with everything OFF; each flag is one
hypothesis -> change -> measure iteration of ``repro``'s §Perf.  Flags
default ON for production use; the dry run traces either state
(``launch.dryrun --perf``), and ``chip_smoke.py``'s phase ``perf_off``
serves the baseline beside the default on the card.

  REPRO_PERF=off   -> all flags off (paper-faithful baseline)
  REPRO_PERF=on    -> all flags on (default)

The model reads the flags at call time (``get()``): the port runs
eagerly, so nothing built under one state outlives a change, except the
param specs ``launch.steps.make_decode_step`` computes when it is called
(as ``repro``'s does).
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class PerfConfig:
    # C1: keep attention inputs bf16 into the score/out products with fp32
    # accumulation instead of materializing fp32 copies of Q/K/V and the
    # KV cache.  Halves score-path HBM traffic.
    bf16_attn_io: bool = True
    # A1: chunked-parallel WKV6 (GLA-style) instead of the per-token scan.
    # A3/A4: chunk length 512 — per-chunk-step loop overhead (backward
    # residual stacking) dominates, so fewer/larger chunks win.
    rwkv_chunked: bool = True
    rwkv_chunk: int = 512
    # B1: bf16 MoE dispatch/combine tensors (routing math stays fp32).
    bf16_moe_dispatch: bool = True
    # B3: GShard grouping = the mesh shards.  Capacity is per (batch-row x
    # model-shard) token block, so the dispatch/combine products contract
    # over *local* tokens — no partial-sum all-reduce of expert buffers at
    # all (EP archs keep one all-to-all to reach their expert owners).
    grouped_moe_dispatch: bool = True
    # C2: local (sliding-window) attention layers keep a rolling window-sized
    # KV cache instead of a full-sequence cache (gemma2 local layers: 4096
    # slots instead of 32768).
    windowed_local_cache: bool = True
    # C3 (refuted in repro, default off): forcing TP-only serving params
    # made decode *worse* — FSDP-sharded weights with row-parallel partial
    # sums read only each device's shard, and stripping the 'data' axis
    # raised per-device weight residency/reads 16x.  Kept as a knob.
    tp_serving_params: bool = False


_ON = PerfConfig()
_OFF = PerfConfig(bf16_attn_io=False, rwkv_chunked=False,
                  bf16_moe_dispatch=False, windowed_local_cache=False,
                  tp_serving_params=False, grouped_moe_dispatch=False)

_current = _OFF if os.environ.get("REPRO_PERF", "on") == "off" else _ON


def get() -> PerfConfig:
    return _current


def set_flags(**kw) -> PerfConfig:
    global _current
    _current = replace(_current, **kw)
    return _current


@contextmanager
def flags(**kw):
    global _current
    old = _current
    _current = replace(_current, **kw)
    try:
        yield _current
    finally:
        _current = old


@contextmanager
def baseline():
    """Paper-faithful: all optimizations off."""
    global _current
    old = _current
    _current = _OFF
    try:
        yield _current
    finally:
        _current = old
