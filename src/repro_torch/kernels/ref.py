"""Plain PyTorch versions of every CUDA kernel (the ground truth for tests).

All convs are NHWC / HWIO at the interface, matching the kernels.  They
accumulate in fp32 and apply the epilogue in the kernels' order.  On CUDA
they run with TF32 off: cuDNN's convolutions default to TF32, which keeps
about three decimal digits and would miss the fp32 tolerance of
2e-4 · scale that the kernels are held to.

The attention functions keep ``repro``'s layouts (q (B, T, H, dh), k/v
(B, S, Kh, dh)) and repeat the fused kernels' arithmetic over the whole key
axis at once: fp32 scores, the ``NEG_INF`` mask, ``p = exp(s - max)`` summed
in fp32 and rounded to v's dtype before the product, and ``acc / max(l,
1e-30)``.  They materialise the (T, S) scores, which the kernels never do.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _exact_fp32(t: torch.Tensor):
    """Context that forbids TF32 in cuDNN and checks it is off for matmuls."""
    if t.device.type != "cuda":
        return contextlib.nullcontext()
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("the fp32 reference needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def epilogue_ref(y: torch.Tensor, scale=None, bias=None, relu: bool = False,
                 residual=None, silu: bool = False) -> torch.Tensor:
    """The epilogue the fused kernels apply at flush, in fp32, unfused.

    Order matches the kernels (and the ResNet bottleneck):
    scale/bias -> residual add -> ReLU; with ``silu`` (EfficientNet's
    blocks) scale/bias -> SiLU -> residual add.
    """
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if silu:
        y = F.silu(y)
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: int = 0, *, scale=None, bias=None, relu: bool = False,
               residual=None, silu: bool = False) -> torch.Tensor:
    """x: (B, H, W, C), w: (FH, FW, C, K) -> (B, OH, OW, K). fp32 accumulate."""
    with _exact_fp32(x):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1),
                     stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1).contiguous()
    return epilogue_ref(y, scale, bias, relu, residual, silu)


def conv1x1_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                scale=None, bias=None, relu: bool = False,
                residual=None, silu: bool = False) -> torch.Tensor:
    """x: (B, H, W, C), w: (C, K); pointwise conv == GEMM over channels."""
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    b, h, wd, c = x.shape
    y = matmul_ref(x.reshape(b * h * wd, c), w).reshape(b, h, wd, -1)
    return epilogue_ref(y, scale, bias, relu, residual, silu)


def matmul_ref(x: torch.Tensor, w: torch.Tensor, *, scale=None, bias=None,
               relu: bool = False, residual=None,
               silu: bool = False) -> torch.Tensor:
    """x: (M, C), w: (C, K) -> (M, K) with fp32 accumulation."""
    with _exact_fp32(x):
        y = torch.matmul(x.float(), w.float())
    return epilogue_ref(y, scale, bias, relu, residual, silu)


def dwconv_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
               scale=None, bias=None, relu: bool = False,
               silu: bool = False) -> torch.Tensor:
    """Depthwise: x (B, H, W, C), w (k, k, 1, C), k odd, padding
    (k - 1) // 2 -> (B, OH, OW, C) in fp32, with the epilogue."""
    k, c = w.shape[0], w.shape[-1]
    with _exact_fp32(x):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), stride=stride,
                     padding=(k - 1) // 2, groups=c)
    y = y.permute(0, 2, 3, 1).contiguous()
    return epilogue_ref(y, scale, bias, relu, None, silu)


def tile_sums_ref(y: torch.Tensor, tile_pix: int) -> torch.Tensor:
    """(B, OH, OW, C) -> fp32 (B, tiles, C): each run of ``tile_pix`` pixels
    (row-major, the last one short) summed by channel."""
    b, oh, ow, c = y.shape
    tiles = -(-oh * ow // tile_pix)
    flat = y.float().reshape(b, oh * ow, c)
    flat = F.pad(flat, (0, 0, 0, tiles * tile_pix - oh * ow))
    return flat.reshape(b, tiles, tile_pix, c).sum(2)


def se_gate_ref(sums: torch.Tensor, npix: int, w1, b1, w2,
                b2) -> torch.Tensor:
    """The squeeze-and-excitation gate from the tiles' sums (B, tiles, C):
    sigmoid(SiLU(mean @ w1 + b1) @ w2 + b2), fp32 (B, C)."""
    mean = sums.float().sum(1) / npix
    with _exact_fp32(sums):
        h = F.silu(mean @ w1.float() + b1.float())
        return torch.sigmoid(h @ w2.float() + b2.float())


def se_scale_ref(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) times the gate (B, C) by image and channel, one
    fp32 product rounded to x's type."""
    return (x.float() * gate.float()[:, None, None, :]).to(x.dtype)


NEG_INF = -2.3819763e38   # bf16-safe large negative, as in the Pallas kernels


def conv1d_causal_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv (Mamba2 / token-shift style), fp32 result.

    x: (B, T, C), w: (FL, C)  ->  (B, T, C);  out[t] = sum_r x[t-FL+1+r] * w[r].
    """
    fl = w.shape[0]
    xf = x.float()
    pad = F.pad(xf, (0, 0, fl - 1, 0))
    out = torch.zeros_like(xf)
    for r in range(fl):
        out = out + pad[:, r:r + x.shape[1], :] * w[r].float()
    return out


def _softmax_out(sc: torch.Tensor, v: torch.Tensor, spec: str):
    """The fused kernels' normalisation on masked fp32 scores (.., S):
    (unnormalised output, row sums, row maxima)."""
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1)
    with _exact_fp32(v):
        acc = torch.einsum(spec, p.to(v.dtype).float(), v.float())
    return acc, l, m[..., 0]


FLASH_REF_ROWS = 2048   # query rows the plain flash scores at once


def flash_attention_ref(q, k, v, *, window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention.  q: (B, T, H, dh); k/v: (B, S, Kh, dh) -> fp32
    (B, T, H, dh).  Row t of q is position ``q_offset + t`` (a sequence
    shard's rows; 0 unsharded); key j is visible to it when j <= q_offset +
    t and, with a window, j > q_offset + t - window; scores are soft-capped
    before the mask, after ``scale`` (dh ** -0.5 by default).  Each row's
    softmax is its own, so a long T is scored
    ``FLASH_REF_ROWS`` query rows at a time (the same math, a bounded (T, S)
    score block)."""
    t = q.shape[1]
    if t > FLASH_REF_ROWS:
        # keys past a block's last row are masked: leave them out
        return torch.cat([
            _flash_rows(q[:, t0:t0 + FLASH_REF_ROWS],
                        k[:, :q_offset + t0 + FLASH_REF_ROWS],
                        v[:, :q_offset + t0 + FLASH_REF_ROWS],
                        q_offset + t0, window, softcap, scale)
            for t0 in range(0, t, FLASH_REF_ROWS)], dim=1)
    return _flash_rows(q, k, v, q_offset, window, softcap, scale)


def _flash_rows(q, k, v, t0: int, window: int, softcap: float,
                scale: float | None = None):
    """Query rows t0 .. t0 + T - 1 of flash_attention_ref (q holds those
    rows, k/v the keys from 0)."""
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, kh, h // kh, dh)
    with _exact_fp32(q):
        sc = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    sc = sc * (dh ** -0.5 if scale is None else scale)
    if softcap and softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    qpos = t0 + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = kpos <= qpos
    if window and window > 0:
        ok = ok & (kpos > qpos - window)
    sc = torch.where(ok, sc, NEG_INF)
    acc, l, _ = _softmax_out(sc, v, "bkgts,bskd->bkgtd")
    out = acc / torch.clamp_min(l, 1e-30)[..., None]       # (B, Kh, G, T, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, dh)


def decode_attention_ref(q, cache_k, cache_v, pos, *, window: int = 0,
                         softcap: float = 0.0, k_offset: int = 0,
                         return_lse: bool = False,
                         scale: float | None = None):
    """One query per sequence against its cache.  q: (B, H, dh); cache:
    (B, S, Kh, dh); pos: (B,) int -> fp32 (B, H, dh).  Cache row j holds
    key ``k_offset + j`` (a cache shard's rows; 0 unsharded); key i is
    visible to sequence b when i <= pos[b] and, with a window, i > pos[b] -
    window; scores are scaled by ``scale`` (dh ** -0.5 by default) and
    soft-capped before the mask.  A sequence that sees no
    row gets a zero output.  With ``return_lse``, also each head's fp32
    log-sum-exp of its visible scores, (B, H) (-inf where none is
    visible)."""
    b, h, dh = q.shape
    s, kh = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, kh, h // kh, dh)
    with _exact_fp32(q):
        sc = torch.einsum("bkgd,bskd->bkgs", qg.float(), cache_k.float())
    sc = sc * (dh ** -0.5 if scale is None else scale)
    if softcap and softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    kpos = k_offset + torch.arange(s, device=q.device)[None, :]
    p = pos.to(q.device).long()[:, None]
    ok = kpos <= p                                                   # (B, S)
    if window and window > 0:
        ok = ok & (kpos > p - window)
    sc = torch.where(ok[:, None, None, :], sc, NEG_INF)
    acc, l, m = _softmax_out(sc, cache_v, "bkgs,bskd->bkgd")
    seen = ok.any(dim=-1)[:, None, None]                         # (B, 1, 1)
    out = torch.where(seen[..., None],
                      acc / torch.clamp_min(l, 1e-30)[..., None], 0.0)
    out = out.reshape(b, h, dh)
    if not return_lse:
        return out
    lse = torch.where(seen, m + torch.log(l), -torch.inf)
    return out, lse.reshape(b, h)
