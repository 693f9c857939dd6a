"""Fused causal flash attention (prefill) — the CUDA kernel's wrapper.

``flash_attention`` runs ``csrc/flash_attention.cu``: causal GQA attention
with the Pallas kernel's online softmax in fp32, an optional sliding
``window`` and tanh ``softcap``, whole KV tiles past the diagonal skipped.
bf16 runs on the tensor cores (``mma.sync``, 128-row query tiles, 64-key
K/V tiles); fp32 on the fp32 CUDA cores (64-row tiles), an exact fp32
result.  Any T and S (the Pallas wrapper needs T % 256 == 0); the head dims
of ``HEAD_DIMS``, those the configs use.  The source's header note says
which Pallas kernel it replaces, what bounds it on the H100 and how its
design answers that.

``flash_attention_plain`` is the plain PyTorch version of the same function.
A tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

BQ, BK = 64, 64     # FA_BQ, FA_BK of csrc/flash_attention.cu (fp32)
MMA_BQ, MMA_BK = 128, 64   # FA_MMA_BQ, FA_MMA_BK (bf16): query rows of a
                           # block, keys of a K/V tile
HEAD_DIMS = (16, 64, 80, 128, 256)   # instantiated in csrc/*_attention.cu

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"carla_flash_attention":
               [_I, _P, _P, _P, _P] + [_I] * 7 + [_F, _F, _P]}


def _shapes(q, k, v):
    b, t, h, dh = q.shape
    b2, s, kh, dh2 = k.shape
    if tuple(v.shape) != tuple(k.shape) or b2 != b or dh2 != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if h % kh:
        raise ValueError(f"flash_attention: {h} heads over {kh} kv heads")
    return b, t, s, h, kh, dh


def flash_attention_plain(q, k, v, *, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math, q's dtype)."""
    return flash_attention_ref(q, k, v, window=window,
                               softcap=softcap).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, T, H, dh); k/v: (B, S, Kh, dh) -> (B, T, H, dh) in q's dtype."""
    b, t, s, h, kh, dh = _shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, softcap=softcap)
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    code = _build.attention_operands("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.carla_flash_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, h, kh, dh, int(window), dh ** -0.5, float(softcap),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
