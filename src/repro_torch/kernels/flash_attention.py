"""Fused causal flash attention (prefill) — the CUDA kernel's wrapper.

``flash_attention`` runs ``csrc/flash_attention.cu``: causal GQA attention
with the Pallas kernel's online softmax in fp32, an optional sliding
``window`` and tanh ``softcap``, whole KV tiles past the diagonal skipped.
bf16 runs on the tensor cores (``mma.sync``, 128-row query tiles, 64-key
K/V tiles); fp32 on the fp32 CUDA cores (64-row tiles), an exact fp32
result.  Any T and S (the Pallas wrapper needs T % 256 == 0); the kernel
is built at the head dims of ``HEAD_DIMS``, those the full configs use, and
any narrower head dim runs zero-padded to the next of them
(``with_padded_head_dim``, the scale kept the unpadded dh's).  The
source's header note says which Pallas kernel it replaces, what bounds it
on the H100 and how its design answers that.

``q_offset`` is the position of q's first row: a shard of a sequence
sharded over a mesh axis holds rows ``q_offset .. q_offset + T - 1`` against
keys from 0 (the caller passes only the ``q_offset + T`` keys it can see).
The kernel, the plain version and the backward all take it; 0 is the
unsharded call.

``flash_attention_plain`` is the plain PyTorch version of the same function.
A tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts launches.

Gradients: ``flash_attention`` is a ``torch.autograd.Function``
(``FlashAttention``), so a loss through the kernel trains ``wq``/``wk``/
``wv``.  Its backward is not a backward kernel: ``repro`` has none (it trains
through its ``jnp`` attention), so the backward recomputes the plain version
under autograd from the saved q, k, v and differentiates that, by blocks of
``FLASH_BWD_ROWS`` query rows (each block's keys stop at its last row), so no
whole (T, S) score matrix is held: dq per block, dk and dv summed over the
blocks, GQA head groups summed by autograd.  A Hopper backward kernel is
later work.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import _flash_rows, flash_attention_ref

BQ, BK = 64, 64     # FA_BQ, FA_BK of csrc/flash_attention.cu (fp32)
MMA_BQ, MMA_BK = 128, 64   # FA_MMA_BQ, FA_MMA_BK (bf16): query rows of a
                           # block, keys of a K/V tile
HEAD_DIMS = (16, 64, 80, 128, 256)   # instantiated in csrc/*_attention.cu

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"carla_flash_attention":
               [_I, _P, _P, _P, _P] + [_I] * 8 + [_F, _F, _P]}


def _shapes(q, k, v):
    b, t, h, dh = q.shape
    b2, s, kh, dh2 = k.shape
    if tuple(v.shape) != tuple(k.shape) or b2 != b or dh2 != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if h % kh:
        raise ValueError(f"flash_attention: {h} heads over {kh} kv heads")
    return b, t, s, h, kh, dh


def flash_attention_plain(q, k, v, *, window: int = 0, softcap: float = 0.0,
                          q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math, q's dtype);
    scores scaled by ``scale``, dh ** -0.5 by default."""
    return flash_attention_ref(q, k, v, window=window, softcap=softcap,
                               q_offset=q_offset, scale=scale).to(q.dtype)


def padded_head_dim(dh: int) -> int:
    """The narrowest head dim the kernels are built at that holds dh."""
    for d in HEAD_DIMS:
        if d >= dh:
            return d
    raise ValueError(f"head dim {dh} above the widest built, {HEAD_DIMS[-1]}")


def with_padded_head_dim(fn, q, k, v, *rest, **kw):
    """``fn(q, k, v, *rest, scale=dh ** -0.5, **kw)`` at a head dim the
    kernels are built at: q, k and v zero-padded along dh to
    ``padded_head_dim(dh)`` and the output sliced back to dh (the first
    of a tuple; a log-sum-exp beside it is the unpadded one).  A zero
    column adds nothing to any q . k, and the padded output columns are
    sums of p x 0; the scale stays the unpadded dh's, or every score would
    be off by sqrt(padded / dh).  The padding copies q, k and v, a KV cache
    included, on every call."""
    dh = q.shape[-1]
    wide = padded_head_dim(dh)
    if wide == dh:
        return fn(q, k, v, *rest, scale=dh ** -0.5, **kw)
    pad = lambda t: torch.nn.functional.pad(t, (0, wide - dh))
    out = fn(pad(q), pad(k), pad(v), *rest, scale=dh ** -0.5, **kw)
    if isinstance(out, tuple):
        return (out[0][..., :dh].contiguous(),) + out[1:]
    return out[..., :dh].contiguous()


FLASH_BWD_ROWS = 512   # query rows per block of the plain backward


def _launch(q, k, v, window: int, softcap: float,
            q_offset: int = 0) -> torch.Tensor:
    """One launch of csrc/flash_attention.cu (counted), at q's head dim
    padded to one the kernel is built at."""
    return with_padded_head_dim(_launch_built, q, k, v, window=window,
                                softcap=softcap, q_offset=q_offset)


def _launch_built(q, k, v, *, window: int, softcap: float, q_offset: int,
                  scale: float) -> torch.Tensor:
    b, t, s, h, kh, dh = _shapes(q, k, v)
    code = _build.attention_operands("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.carla_flash_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, h, kh, dh, int(window), int(q_offset), float(scale),
            float(softcap),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_grads(q, k, v, g, *, window: int = 0,
                          softcap: float = 0.0, q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention_plain`` for the cotangent g, by
    blocks of ``FLASH_BWD_ROWS`` query rows: each block recomputes its rows
    under autograd against the keys up to its last row."""
    t = q.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for t0 in range(0, t, FLASH_BWD_ROWS):
        t1 = min(t, t0 + FLASH_BWD_ROWS)
        qb = q[:, t0:t1].detach().requires_grad_()
        k1 = q_offset + t1          # keys up to the block's last row
        kb = k[:, :k1].detach().requires_grad_()
        vb = v[:, :k1].detach().requires_grad_()
        with torch.enable_grad():
            out = _flash_rows(qb, kb, vb, q_offset + t0, window,
                              softcap).to(q.dtype)
            gq, gk, gv = torch.autograd.grad(out, (qb, kb, vb), g[:, t0:t1])
        dq[:, t0:t1] = gq
        dk[:, :k1] += gk
        dv[:, :k1] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The kernel forward (the plain version on the CPU) with the blocked
    plain backward of ``flash_attention_grads``."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float, q_offset: int):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.softcap, ctx.q_offset = window, softcap, q_offset
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, window=window,
                                         softcap=softcap, q_offset=q_offset)
        return _launch(q, k, v, window, softcap, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_grads(q, k, v, g, window=ctx.window,
                                           softcap=ctx.softcap,
                                           q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, T, H, dh); k/v: (B, S, Kh, dh) -> (B, T, H, dh) in q's dtype.

    Differentiable in q, k and v (``FlashAttention``)."""
    _shapes(q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    return FlashAttention.apply(q, k, v, int(window), float(softcap),
                                int(q_offset))


flash_attention.launches = 0
