"""Gradient compression with error feedback (port of
``repro.optim.compression``): bf16 (2x fewer bytes on the wire) and
per-tensor symmetric int8 (4x), each wrapped in error feedback so the
compression noise does not accumulate.  On one card nothing is all-reduced;
the functions are kept for the multi-card data-parallel path.
"""
from __future__ import annotations

import torch

from ..pytree import tree_map


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return tree_map(lambda g: g.float(), grads)


def _q8(g):
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8), \
        scale


def compress_int8(grads):
    """Per-tensor symmetric int8 quantization.  Returns (q, scales)."""
    return tree_map(lambda g: _q8(g)[0], grads), \
        tree_map(lambda g: _q8(g)[1], grads)


def decompress_int8(qs, ss):
    return tree_map(lambda q, s: q.float() * s, qs, ss)


def error_feedback_compress(grads, residual, compress, decompress):
    """g' = C(g + r);  r' = (g + r) - D(C(g + r)).  Returns (g', r').
    ``residual=None`` starts from fp32 zeros."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)
    corrected = tree_map(lambda g, r: g.float() + r, grads, residual)
    compressed = compress(corrected)
    if isinstance(compressed, tuple):
        restored = decompress(*compressed)
    else:
        restored = decompress(compressed)
    new_residual = tree_map(lambda c, r: c - r, corrected, restored)
    return compressed, new_residual
