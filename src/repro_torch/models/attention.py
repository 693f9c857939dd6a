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
kernel, which, like the Pallas one, takes only the causal mask ``kpos <=
pos``: windowed and soft-capped decode raise NotImplementedError.  The
attention operands go to the kernels in the activations' dtype (``repro``'s
default ``bf16_attn_io``); caches are never rolling windows, since every
layer that would need one raises in decode.
"""
from __future__ import annotations

import torch

from ..kernels import decode_attention as _decode
from ..kernels import flash_attention as _flash
from ..kernels.ops import resolve
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
    if pos is None:
        pos = torch.arange(t, device=x.device)[None].expand(b, t)
    if mrope_sections is not None:
        p3 = pos3 if pos3 is not None else pos[None].expand(3, b, t)
        q = apply_mrope(q, p3, rope_theta, mrope_sections)
        k = apply_mrope(k, p3, rope_theta, mrope_sections)
    else:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    fn = (_flash.flash_attention if resolve(impl, x) == "cuda"
          else _flash.flash_attention_plain)
    out = fn(q, k, v, window=int(window),
             softcap=attn_softcap).to(x.dtype)
    return dense(params["wo"], out.reshape(b, t, -1), x.dtype), (k, v)


def attention_decode(params, x, cache_k, cache_v, pos, *, n_heads: int,
                     n_kv_heads: int, d_head: int, rope_theta: float = 1e4,
                     window: int = 0, attn_softcap: float = 0.0,
                     mrope_sections=None, impl: str = "auto"):
    """One-token decode.  x: (B, 1, d); cache_{k,v}: (B, S, Kh, dh); pos: (B,).

    Writes this token's k/v at slot ``pos`` of the cache in place and returns
    (out, cache_k, cache_v) — the same cache tensors, updated.
    """
    if (window and window > 0) or (attn_softcap and attn_softcap > 0):
        raise NotImplementedError(
            "attention_decode: windowed and soft-capped decode (gemma2, "
            "mixtral) are not ported; the decode kernel, like the Pallas one, "
            "takes only the causal mask (ROADMAP.md, Queue 1)")
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

    rows = torch.arange(b, device=x.device)
    cache_k[rows, pos.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos.long()] = v[:, 0].to(cache_v.dtype)

    fn = (_decode.decode_attention if resolve(impl, x) == "cuda"
          else _decode.decode_attention_plain)
    out = fn(q[:, 0], cache_k, cache_v, pos.to(torch.int32)).to(x.dtype)
    return dense(params["wo"], out.reshape(b, 1, -1), x.dtype), cache_k, cache_v
