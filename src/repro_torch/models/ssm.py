"""Mamba2 (SSD), the attention-free mixer of zamba2 (port of the Mamba2 half
of ``repro.models.ssm``; the RWKV-6 half waits, see ROADMAP.md).

O(T) in sequence length: prefill uses the chunked SSD form, decode one
recurrent step against an O(1) state.  The short causal conv (d_conv = 4) is
a depthwise causal conv, which runs through ``kernels.ops.conv1d_causal``
(the CUDA kernel on CUDA tensors; the reference calls its ``jnp`` oracle).
Casts follow ``repro``: projections in the activation dtype (bf16), silu,
softplus and the gated RMSNorm in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import dense, dense_init, normal


def mamba2_init(gen, d_model: int, d_state: int, *, expand: int = 2,
                head_dim: int = 64, d_conv: int = 4, device="cpu"):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    d_xbc = d_inner + 2 * d_state            # x + B + C (single group)
    return {
        "in_proj": dense_init(gen, d_model,
                              2 * d_inner + 2 * d_state + n_heads,
                              device=device),
        "conv_w": normal(gen, (d_conv, d_xbc), 0.2, device),
        "A_log": torch.zeros(n_heads, device=device),     # A = -exp(A_log)
        "D": torch.ones(n_heads, device=device),
        "dt_bias": torch.full((n_heads,), -2.0, device=device),
        "norm_g": torch.ones(d_inner, device=device),
        "out_proj": dense_init(gen, d_inner, d_model, device=device),
    }


def _ssd_chunked(xh, log_a, B, C, chunk: int):
    """Chunked SSD scan (Mamba-2).

    xh: (b, T, H, P) inputs already scaled by dt; log_a: (b, T, H) decay logs;
    B, C: (b, T, N).  Returns ((b, T, H, P), final_state (b, H, N, P)).
    """
    b, t, h, p = xh.shape
    n = B.shape[-1]
    nc = t // chunk
    xh = xh.reshape(b, nc, chunk, h, p)
    la = log_a.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    cum = torch.cumsum(la, dim=2)                              # (b,nc,L,H)
    total = cum[:, :, -1]                                      # (b,nc,H)

    # intra-chunk (quadratic within the chunk)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,nc,L,L,H) i,j
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=xh.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], rel,
                                  -torch.inf))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xh)

    # chunk-final states: S_c = sum_j exp(total - cum_j) B_j x_j^T
    w = torch.exp(total[:, :, None] - cum)                     # (b,nc,L,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w, xh)  # (b,nc,H,N,P)

    # inter-chunk recurrence over the chunk index
    s = torch.zeros((b, h, n, p), dtype=xh.dtype, device=xh.device)
    before = []
    for c in range(nc):
        before.append(s)
        s = s * torch.exp(total[:, c])[..., None, None] + states[:, c]
    s_before = torch.stack(before, dim=1)                      # (b,nc,H,N,P)

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp",
                           Cc, torch.exp(cum), s_before)
    return (y_intra + y_inter).reshape(b, t, h, p), s


def _split_proj(zxbcdt, d_inner: int, d_state: int):
    """(z, xBC, dt) at ``repro``'s boundaries [d_inner, 2 d_inner + 2 d_state]."""
    rest = zxbcdt.shape[-1] - 2 * d_inner - 2 * d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * d_state, rest], dim=-1)


def _gated_norm(y, z, norm_g, dtype):
    """Mamba2's gated RMSNorm, in fp32."""
    yf = y.float() * F.silu(z.float())
    rms = torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    return (yf * rms * norm_g).to(dtype)


def mamba2(params, x, *, d_state: int, head_dim: int = 64, chunk: int = 64,
           return_state: bool = False, impl: str = "auto"):
    """x: (b, T, d_model) -> (b, T, d_model).  Training / prefill form.

    With ``return_state`` also returns (ssm_state, conv_state) for decode."""
    b, t, d = x.shape
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"mamba2: T = {t} is not a multiple of the "
                         f"{chunk}-token SSD chunk")
    d_inner = params["norm_g"].shape[0]
    n_heads = d_inner // head_dim

    zxbcdt = dense(params["in_proj"], x, x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, d_state)

    # short causal depthwise conv: the conv1d kernel on CUDA
    xbc_raw = xbc
    xbc = F.silu(ops.conv1d_causal(xbc, params["conv_w"], impl=impl).float()
                 ).to(x.dtype)
    xs, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])                  # (b,T,H)
    A = -torch.exp(params["A_log"])                                  # (H,)
    log_a = dt * A                                                   # (b,T,H)

    xh = xs.reshape(b, t, n_heads, head_dim)
    xdt = xh.float() * dt[..., None]
    y, s_final = _ssd_chunked(xdt, log_a, B.float(), C.float(), chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, t, d_inner).to(x.dtype)

    y = _gated_norm(y, z, params["norm_g"], x.dtype)
    out = dense(params["out_proj"], y, x.dtype)
    if return_state:
        d_conv = params["conv_w"].shape[0]
        conv_state = xbc_raw[:, t - (d_conv - 1):, :].float()
        return out, (s_final, conv_state)
    return out


def mamba2_decode(params, x, state, conv_state, *, d_state: int,
                  head_dim: int = 64):
    """One-token step.  x: (b, 1, d); state: (b, H, N, P);
    conv_state: (b, d_conv-1, d_xbc).  Returns (y, state, conv_state).

    The conv over the d_conv-slot window is one einsum, as in ``repro``."""
    b = x.shape[0]
    d_inner = params["norm_g"].shape[0]
    n_heads = d_inner // head_dim

    zxbcdt = dense(params["in_proj"], x, x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, d_state)

    window = torch.cat([conv_state, xbc.to(conv_state.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", window.float(), params["conv_w"])
    xbc1 = F.silu(out)[:, None, :].to(x.dtype)                 # (b,1,d_xbc)
    new_conv_state = window[:, 1:]

    xs, B, C = torch.split(xbc1, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]        # (b,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)                                        # (b,H)

    xh = xs.reshape(b, n_heads, head_dim).float()
    Bv = B[:, 0].float()                                         # (b,N)
    Cv = C[:, 0].float()
    upd = torch.einsum("bn,bh,bhp->bhnp", Bv, dt, xh)
    state = state * a[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cv, state)
    y = y + params["D"][None, :, None] * xh
    y = _gated_norm(y.reshape(b, 1, d_inner), z, params["norm_g"], x.dtype)
    return dense(params["out_proj"], y, x.dtype), state, new_conv_state
