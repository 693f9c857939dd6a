"""Filter-plane decomposition — paper §III.D / Fig 7, explicitly.

CARLA handles FL >= 5 by splitting each filter row into pieces of at most
N=3 taps (the CU has 3 cascaded PEs).  A 7x7 filter becomes 21 pieces:
14 rows-of-3 and 7 rows-of-1 (7 = 3+3+1 per row, 7 rows).  Each piece runs
on the 3x3 row-wise machinery; the analytic model charges a pass per piece.

On the GPU the register-width constraint disappears (the implicit-GEMM
kernel of kernels/conv2d.py walks every tap), so this module serves the
analytic model, the tests that pin the paper's numbers, and as executable
documentation; correctness is proven by reassembling a conv from its
pieces.  The port of ``repro.core.decompose``: ``decompose_filter`` and
``piece_count`` are copied as they are, ``conv_from_pieces`` runs on torch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ref import conv2d_ref
from .modes import N_PE_PER_CU


@dataclass(frozen=True)
class FilterPiece:
    row: int          # filter row index
    col_start: int    # first tap column
    n_taps: int       # 1..N_PE_PER_CU


def decompose_filter(fl: int, n: int = N_PE_PER_CU) -> list[FilterPiece]:
    """Split an FL x FL filter plane into rows of <= n taps (Fig 7)."""
    pieces = []
    for r in range(fl):
        c = 0
        while c < fl:
            taps = min(n, fl - c)
            pieces.append(FilterPiece(r, c, taps))
            c += taps
    return pieces


def piece_count(fl: int, n: int = N_PE_PER_CU) -> tuple[int, int, int]:
    """(total, full-width pieces, remainder pieces) — Fig 7: 7x7 -> (21,14,7)."""
    ps = decompose_filter(fl, n)
    full = sum(1 for p in ps if p.n_taps == n)
    return len(ps), full, len(ps) - full


def conv_from_pieces(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """Reassemble conv(x, w) as the sum of per-piece row convolutions.

    Numerically identical to the direct convolution — the §III.D claim that
    piece-wise computation 'preserves computation flow homogeneity' without
    changing results.  x: (B,H,W,C); w: (FL,FL,C,K).
    """
    fl = w.shape[0]
    out = None
    for p in decompose_filter(fl):
        cols = slice(p.col_start, p.col_start + p.n_taps)
        wp = torch.zeros_like(w)
        wp[p.row, cols] = w[p.row, cols]
        y = conv2d_ref(x, wp, stride=stride, padding=padding)
        out = y if out is None else out + y
    return out
