"""Grouped-query attention with RoPE / M-RoPE, soft-capping, sliding windows,
and a KV cache for decode (port of ``repro.models.attention``).

Layouts are ``repro``'s: x (B, T, d), q (B, T, H, dh), k/v and the cache
(B, S, Kh, dh).  Score/softmax math is fp32; activations bf16.

Where the reference picks a dense masked softmax (T <= 1024) or a blockwise
``jnp`` flash scan (T > 1024), ``attention`` here always calls the flash
kernel (``kernels.flash_attention``): both reference paths compute the same
function, and the kernel's plain version runs on the CPU or with
``impl="ref"``.  ``attention_decode`` writes the new token's k/v into the
cache in place (the reference returns a new cache) and calls the decode
kernel, which takes the soft-cap, a window over a linear cache, and, through
the position it is given, a rolling cache (``rolling_window``).

``perf.bf16_attn_io`` (on by default, as in ``repro``) hands the kernels
their operands in the activations' dtype: the bf16 instances, which round
p to bf16 before P·V.  Off (the paper-faithful baseline), the kernels get
fp32 copies of q, k and v (in decode, of q and the cache, after the new
token is written into the cache in its own dtype) and run their fp32
instances, which do not round; the output is cast back to the
activations' dtype and the cache stays in its own, as ``repro``'s
``_gqa_scores``/``_gqa_out`` and ``flash_attention`` do.

Under a sharded step (``sharding_hints.local_tokens``) the tokens of a
sequence are sharded: ``attention`` ropes this shard's rows at their own
positions, gathers K/V over the sequence's shards (``repro``'s anchors at
``models/attention.py:151-155``) and runs the flash kernel with the
shard's ``q_offset`` against only the keys up to its last row.
``attention_decode`` over a cache sharded along S writes the new token
into the shard that holds its slot, runs the decode kernel on each shard's
rows with its key offset and log-sum-exp, and combines the shards
(``decode_attention.combine_shards``).
"""
from __future__ import annotations

import torch

from .. import perf
from ..kernels import decode_attention as _decode
from ..kernels import flash_attention as _flash
from ..kernels.ops import resolve
from . import sharding_hints as hints
from .layers import dense, dense_init


# ------------------------------- RoPE ----------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def _rotate(x, ang):
    """Rotate the two halves of x's last dim by ang (B, T, dh/2)."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x: (B, T, H, dh); pos: (B, T) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (dh/2,)
    return _rotate(x, pos[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE.  pos3: (3, B, T) = (temporal, h, w) ids.

    The dh/2 rotary frequencies are split into three contiguous sections,
    each rotated by its own position stream.  For pure-text positions the
    three streams coincide and M-RoPE == RoPE.
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])           # (dh/2,)
    pos_sel = pos3.float()[sec]                                  # (dh/2, B, T)
    return _rotate(x, torch.movedim(pos_sel, 0, -1) * freqs)


# ------------------------------ params ---------------------------------------
def attention_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   d_head: int, *, device="cpu"):
    return {
        "wq": dense_init(gen, d_model, n_heads * d_head, device=device),
        "wk": dense_init(gen, d_model, n_kv_heads * d_head, device=device),
        "wv": dense_init(gen, d_model, n_kv_heads * d_head, device=device),
        "wo": dense_init(gen, n_heads * d_head, d_model, device=device),
    }


def _qkv(params, x, n_heads, n_kv_heads, d_head):
    b, t, _ = x.shape
    q = dense(params["wq"], x, x.dtype).reshape(b, t, n_heads, d_head)
    k = dense(params["wk"], x, x.dtype).reshape(b, t, n_kv_heads, d_head)
    v = dense(params["wv"], x, x.dtype).reshape(b, t, n_kv_heads, d_head)
    return q, k, v


def _io(*ts):
    """The attention kernels' operands: as they are under
    ``perf.bf16_attn_io``, else fp32 copies."""
    if perf.get().bf16_attn_io:
        return ts
    return tuple(t.float() for t in ts)


# ------------------------------ forward --------------------------------------
def attention(params, x, *, n_heads: int, n_kv_heads: int, d_head: int,
              rope_theta: float = 1e4, window: int = 0,
              attn_softcap: float = 0.0, mrope_sections=None, pos=None,
              pos3=None, impl: str = "auto"):
    """Full (training / prefill) self-attention.  x: (B, T, d).

    Returns (out, (k, v)) with k/v (B, T, Kh, dh) after RoPE.
    """
    b, t, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv_heads, d_head)
    t0 = hints.seq_offset(t)      # this shard's first position (0 unsharded)
    if pos is None:
        pos = torch.arange(t0, t0 + t, device=x.device)[None].expand(b, t)
    if mrope_sections is not None:
        p3 = pos3 if pos3 is not None else pos[None].expand(3, b, t)
        q = apply_mrope(q, p3, rope_theta, mrope_sections)
        k = apply_mrope(k, p3, rope_theta, mrope_sections)
    else:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    k, v = hints.gather_seq(k), hints.gather_seq(v)   # the keys from 0
    ks, vs = k, v
    if t0 + t < k.shape[1]:   # keys past this shard's last row: never seen
        ks, vs = k[:, :t0 + t].contiguous(), v[:, :t0 + t].contiguous()
    fn = (_flash.flash_attention if resolve(impl, x) == "cuda"
          else _flash.flash_attention_plain)
    out = fn(*_io(q, ks, vs), window=int(window), softcap=attn_softcap,
             q_offset=t0).to(x.dtype)
    return dense(params["wo"], out.reshape(b, t, -1), x.dtype), (k, v)


def attention_decode(params, x, cache_k, cache_v, pos, *, n_heads: int,
                     n_kv_heads: int, d_head: int, rope_theta: float = 1e4,
                     window: int = 0, attn_softcap: float = 0.0,
                     mrope_sections=None, rolling_window: int = 0,
                     impl: str = "auto"):
    """One-token decode.  x: (B, 1, d); cache_{k,v}: (B, S, Kh, dh); pos: (B,).

    Writes this token's k/v into the cache in place and returns (out,
    cache_k, cache_v) — the same cache tensors, updated.

    A linear cache (``rolling_window`` 0) holds position j in slot j: the
    new k/v go to slot ``pos`` (which must be < S), and the kernel masks
    keys past ``pos`` and, with a ``window``, keys at or before ``pos -
    window``.  With ``rolling_window`` W > 0 the cache is a ring of W slots
    (a sliding-window layer's, ``W = min(window, max_seq)``): the new k/v go
    to slot ``pos % W``, and slot s holds the token at position ``pos -
    ((pos - s) mod W)``, a real token exactly when ``s <= min(pos, W -
    1)`` (before the ring fills, the slots past ``pos`` are empty; after,
    all W slots hold the window).  So the kernel is given ``min(pos, W -
    1)`` as the position and no window: its causal mask is then the ring's,
    and softmax does not depend on the keys' order.
    """
    b = x.shape[0]
    q, k, v = _qkv(params, x, n_heads, n_kv_heads, d_head)
    posb = pos[:, None]                                    # (B, 1)
    if mrope_sections is not None:
        p3 = posb[None].expand(3, b, 1)
        q = apply_mrope(q, p3, rope_theta, mrope_sections)
        k = apply_mrope(k, p3, rope_theta, mrope_sections)
    else:
        q = apply_rope(q, posb, rope_theta)
        k = apply_rope(k, posb, rope_theta)

    if rolling_window:
        slot = (pos % rolling_window).long()
        kpos, window = torch.clamp(pos, max=rolling_window - 1), 0
    else:
        slot, kpos = pos.long(), pos
    rows = torch.arange(b, device=x.device)
    fn = (_decode.decode_attention if resolve(impl, x) == "cuda"
          else _decode.decode_attention_plain)
    kpos = kpos.to(torch.int32)
    if hints.kv_shards() == 1:
        cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
        out = fn(*_io(q[:, 0], cache_k, cache_v), kpos, window=int(window),
                 softcap=attn_softcap)
    else:
        # this shard holds slots s0 .. s0 + n - 1: the new k/v land only in
        # the shard that holds their slot
        n = cache_k.shape[1]
        s0 = hints.kv_offset(n)
        loc = slot - s0
        mine = ((loc >= 0) & (loc < n))[:, None, None]
        loc = loc.clamp(0, n - 1)
        cache_k[rows, loc] = torch.where(mine, k[:, 0].to(cache_k.dtype),
                                         cache_k[rows, loc])
        cache_v[rows, loc] = torch.where(mine, v[:, 0].to(cache_v.dtype),
                                         cache_v[rows, loc])
        out, lse = fn(*_io(q[:, 0], cache_k, cache_v), kpos,
                      window=int(window), softcap=attn_softcap, k_offset=s0,
                      return_lse=True)
        out = hints.combine_kv(out, lse, _decode.combine_shards)
    out = out.to(x.dtype)
    return dense(params["wo"], out.reshape(b, 1, -1), x.dtype), cache_k, cache_v
