"""Fused decode attention — the CUDA kernel's wrapper.

``decode_attention`` runs ``csrc/decode_attention.cu``: one query token per
sequence against its KV cache, key j visible when ``j <= pos[b]`` and, with
a ``window``, ``j > pos[b] - window``; scores soft-capped (``softcap *
tanh(s / softcap)``) before the mask when ``softcap`` > 0; the softmax in
fp32 with p rounded to the cache's dtype before the product.  One launch:
the cache is cut into splits of whole ``CHUNK``-row tiles, each block
streams its split's tiles and writes its partial softmax to an fp32
workspace, and the last split of each (b, kh) to finish combines them in a
fixed order; splits past ``pos[b]``, and splits wholly before the window,
read nothing.  A head dim between the built ones runs zero-padded to the
next (``flash_attention.with_padded_head_dim``, the scale and the
log-sum-exp the unpadded dh's; the padded copy of the cache costs a read
and a write of it a call).  A rolling cache (a ring of W slots) is the
caller's mapping: ``models.attention.attention_decode`` passes
``min(pos, W - 1)``, under which this causal mask is the ring's.  ``pos``
must be >= 0, and at a built head dim (H / Kh) * dh may be at most 2048.
A head dim above 256, up to ``flash_attention.WIDE_MAX_HEAD_DIM``, runs
the wide kernel unpadded (dh a runtime argument; one block a split of a kv
head, as the narrow kernel, its rows brought in by bulk copies and scored
for all heads of the group), with the same splits, workspace, tickets and
combine.

Cache shards: a cache whose S axis is sharded over a mesh holds, on each
shard, rows ``k_offset .. k_offset + S - 1``; the kernel masks row j as key
``k_offset + j``, so pos and the window stay the sequence's own.
``return_lse=True`` also returns each head's fp32 log-sum-exp, (B, H),
-inf on a shard with no visible row (whose output is 0), and
``combine_shards`` merges the shards' outputs by it in a fixed order.  ``launch_plan`` sizes the
grid, the workspace and the ticket counters.  The source's header note says
which Pallas kernel it replaces, what bounds it on the H100 and how its
design answers that.

``decode_attention_plain`` is the plain PyTorch version of the same function.
A tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``decode_attention.launches`` counts launches.  Forward only: no training path
reaches this kernel (serving runs it), and its output carries no gradient.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .flash_attention import with_padded_head_dim
from .ref import decode_attention_ref

CHUNK = 64          # DA_CH of csrc/decode_attention.cu: rows of a tile

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"carla_decode_attention":
               [_I] + [_P] * 8 + [_I] * 9 + [_F, _F, _P],
               "carla_decode_occupancy": [_I] * 4 + [_P]}

# (device, dtype code, heads per kv head, dh) -> blocks the card holds at once
_slots: dict[tuple, int] = {}


def decode_attention_plain(q, cache_k, cache_v, pos, *, window: int = 0,
                           softcap: float = 0.0, k_offset: int = 0,
                           return_lse: bool = False,
                           scale: float | None = None):
    """The kernel's function in plain PyTorch (fp32 math, q's dtype; the
    log-sum-exp fp32); scores scaled by ``scale``, dh ** -0.5 by
    default."""
    out = decode_attention_ref(q, cache_k, cache_v, pos, window=window,
                               softcap=softcap, k_offset=k_offset,
                               return_lse=return_lse, scale=scale)
    if return_lse:
        return out[0].to(q.dtype), out[1]
    return out.to(q.dtype)


def combine_shards(outs, lses) -> torch.Tensor:
    """One output from the outputs of n cache shards, (n, B, H, dh), and
    their log-sum-exps, (n, B, H): M = max_i lse_i, then sum_i out_i
    e^(lse_i - M) / sum_i e^(lse_i - M), summed in shard order in fp32, in
    the outputs' dtype.  A shard with lse -inf weighs 0."""
    m = lses.amax(dim=0)
    num = torch.zeros(outs.shape[1:], dtype=torch.float32, device=outs.device)
    den = torch.zeros(lses.shape[1:], dtype=torch.float32, device=outs.device)
    for o, l in zip(outs, lses):
        w = torch.exp(l - m)
        num = num + o.float() * w[..., None]
        den = den + w
    return (num / den[..., None]).to(outs.dtype)


class DecodePlan(NamedTuple):
    splits: int        # splits of the cache per (b, kh): the grid's x extent
    split_tiles: int   # CHUNK-row tiles a split streams
    ws_floats: int     # fp32 workspace: a max, a sum and dh outputs per
                       # (b, kh, split, head of the group)
    tickets: int       # int32 counters, one per (b, kh)


def launch_plan(b: int, s: int, h: int, kh: int, dh: int,
                slots: int) -> DecodePlan:
    """The grid, workspace and counters of one launch over a cache of S
    rows, for a card that holds ``slots`` blocks at once: as many splits
    per (b, kh) as fit in one wave, each whole tiles and none empty."""
    tiles = -(-s // CHUNK)
    want = max(1, slots // (b * kh))
    split_tiles = -(-tiles // min(want, tiles))
    splits = -(-tiles // split_tiles)
    return DecodePlan(splits, split_tiles,
                      b * kh * splits * (h // kh) * (2 + dh), b * kh)


def _resident_blocks(lib, device, code: int, h: int, kh: int, dh: int) -> int:
    key = (device, code, h // kh, dh)
    if key not in _slots:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.carla_decode_occupancy(code, h, kh, dh,
                                                    ctypes.addressof(n)),
                         "decode_attention occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _slots[key] = sms * n.value
    return _slots[key]


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     k_offset: int = 0, return_lse: bool = False):
    """q: (B, H, dh); cache: (B, S, Kh, dh); pos: (B,) int -> (B, H, dh),
    and with ``return_lse`` the (B, H) fp32 log-sum-exp beside it."""
    b, h, dh = q.shape
    b2, s, kh, dh2 = cache_k.shape
    if (tuple(cache_v.shape) != tuple(cache_k.shape) or b2 != b or dh2 != dh
            or h % kh or tuple(pos.shape) != (b,)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)}/{tuple(cache_v.shape)}, "
                         f"pos {tuple(pos.shape)} do not agree")
    if k_offset < 0:
        raise ValueError(f"decode_attention: k_offset {k_offset} < 0")
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos,
                                      window=window, softcap=softcap,
                                      k_offset=k_offset,
                                      return_lse=return_lse)
    if pos.device != q.device or pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32 on {q.device}, "
                        f"got {pos.dtype} on {pos.device}")
    return with_padded_head_dim(_launch, q, cache_k, cache_v,
                                pos.contiguous(), window=window,
                                softcap=softcap, k_offset=k_offset,
                                return_lse=return_lse)


def _launch(q, cache_k, cache_v, pos, *, window: int, softcap: float,
            k_offset: int, return_lse: bool, scale: float):
    """One launch of csrc/decode_attention.cu (counted), at a head dim it
    is built at."""
    b, h, dh = q.shape
    s, kh = cache_k.shape[1], cache_k.shape[2]
    code = _build.attention_operands("decode_attention", q=q, k=cache_k,
                                     v=cache_v)
    lib = _build.load("decode_attention", _SIGNATURES)
    plan = launch_plan(b, s, h, kh, dh,
                       _resident_blocks(lib, q.device, code, h, kh, dh))
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=q.device)
    tickets = _build.ticket_counters(q.device, plan.tickets)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = lib.carla_decode_attention(
            code, q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            pos.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, ws.data_ptr(),
            tickets.data_ptr(), b, s, h, kh, dh, plan.splits,
            plan.split_tiles, int(window), int(k_offset), float(scale),
            float(softcap), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
