"""Assigned input-shape set for the LM-family architectures (a copy of
``repro.configs.shapes``).

Every architecture is paired with the same four shapes (40 cells total):
  * train_4k    — training step, seq 4096, global batch 256
  * prefill_32k — inference prefill, seq 32768, global batch 32
  * decode_32k  — one new token vs a 32k KV cache, global batch 128
  * long_500k   — one new token vs a 524,288-token cache, global batch 1

``decode_*`` / ``long_*`` lower ``serve_step`` (decode), not ``train_step``.
Note (DESIGN.md §5): long_500k is a *decode* shape, so per-step attention cost
is O(S) even for full-attention archs — no arch is skipped; SSM/hybrid archs
additionally have O(1) state.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# reduced shapes for CPU smoke tests
SMOKE_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 32, 2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 64, 2),
    "long_500k": ShapeSpec("long_500k", "decode", 128, 1),
}
