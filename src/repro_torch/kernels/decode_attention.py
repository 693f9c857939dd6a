"""Fused decode attention — the CUDA kernel's wrapper.

``decode_attention`` runs ``csrc/decode_attention.cu``: one query token per
sequence against its KV cache, key j visible when ``j <= pos[b]``, the
softmax in fp32 with p rounded to the cache's dtype before the product.  The
cache is cut into chunks of ``CHUNK`` rows, each chunk's partial softmax goes
to an fp32 workspace, and a second kernel combines the chunks in a fixed
order; chunks past ``pos[b]`` read nothing.  ``pos`` must lie in [0, S).
The source's header note says which Pallas kernel it replaces, what bounds
it on the H100 and how its design answers that.

``decode_attention_plain`` is the plain PyTorch version of the same function.
A tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``decode_attention.launches`` counts calls (each runs the two kernels).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import HEAD_DIMS
from .ref import decode_attention_ref

CHUNK = 128         # DA_CH of csrc/decode_attention.cu

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"carla_decode_attention":
               [_I] + [_P] * 6 + [_I] * 5 + [_F, _P]}


def decode_attention_plain(q, cache_k, cache_v, pos) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math, q's dtype)."""
    return decode_attention_ref(q, cache_k, cache_v, pos).to(q.dtype)


def workspace_floats(b: int, s: int, h: int, kh: int, dh: int) -> int:
    """fp32 values of the per-chunk (max, sum, output) workspace."""
    return b * kh * -(-s // CHUNK) * (h // kh) * (2 + dh)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """q: (B, H, dh); cache: (B, S, Kh, dh); pos: (B,) int -> (B, H, dh)."""
    b, h, dh = q.shape
    b2, s, kh, dh2 = cache_k.shape
    if (tuple(cache_v.shape) != tuple(cache_k.shape) or b2 != b or dh2 != dh
            or h % kh or tuple(pos.shape) != (b,)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)}/{tuple(cache_v.shape)}, "
                         f"pos {tuple(pos.shape)} do not agree")
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos)
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    code = _build.attention_operands("decode_attention", q=q, k=cache_k,
                                     v=cache_v)
    if pos.device != q.device or pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32 on {q.device}, "
                        f"got {pos.dtype} on {pos.device}")
    pos = pos.contiguous()
    ws = torch.empty(workspace_floats(b, s, h, kh, dh), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    lib = _build.load("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.carla_decode_attention(
            code, q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            pos.data_ptr(), out.data_ptr(), ws.data_ptr(), b, s, h, kh, dh,
            dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
