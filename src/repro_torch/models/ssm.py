"""Attention-free mixers (port of ``repro.models.ssm``):

* Mamba2 (SSD), zamba2's mixer.  O(T) in sequence length: prefill uses the
  chunked SSD form, decode one recurrent step against an O(1) state.  The
  short causal conv (d_conv = 4) is a depthwise causal conv, which runs
  through ``kernels.ops.conv1d_causal`` (the CUDA kernel on CUDA tensors;
  the reference calls its ``jnp`` oracle).  Casts follow ``repro``:
  projections in the activation dtype (bf16), silu, softplus and the gated
  RMSNorm in fp32.
* RWKV-6 (Finch), rwkv6-1.6b's mixer: the WKV recurrence with
  data-dependent decay, chunked (``_wkv_chunked``, chunks of
  ``perf.rwkv_chunk`` tokens) where ``repro`` takes its chunked form
  (``perf.rwkv_chunked``, T > 1 and a multiple of the chunk, or T <= the
  chunk) and per token otherwise (``_wkv_recurrent``: decode, and every T
  in the paper-faithful baseline).  The chunked form's products take
  operands rounded to bf16 under ``perf.bf16_attn_io`` (the default) and
  fp32 ones without it.  The token shift ``lerp(x_{t-1}, x_t, mu)`` is a
  depthwise causal conv with taps ``(1 - mu, mu)``, so it runs through the
  conv1d kernel at FL 2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import perf
from ..kernels import ops
from . import loops
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


# ------------------------------- RWKV-6 --------------------------------------
def rwkv6_init(gen, d_model: int, n_heads: int, *, d_ff: int | None = None,
               decay_rank: int = 64, device="cpu"):
    d_ff = d_ff if d_ff is not None else 4 * d_model
    dh = d_model // n_heads
    s = d_model ** -0.5
    lin = lambda d_in, d_out: dense_init(gen, d_in, d_out, device=device)
    return {
        "mu_x": torch.full((d_model,), 0.5, device=device),  # time-mix lerp
        "wr": lin(d_model, d_model),
        "wk": lin(d_model, d_model),
        "wv": lin(d_model, d_model),
        "wg": lin(d_model, d_model),
        "wo": lin(d_model, d_model),
        # data-dependent decay (Finch): w_t = w0 + tanh(x A) B
        "w0": torch.full((d_model,), -6.0, device=device),
        "wA": normal(gen, (d_model, decay_rank), s, device),
        "wB": normal(gen, (decay_rank, d_model), decay_rank ** -0.5, device),
        "u": normal(gen, (n_heads, dh), 0.1, device),
        "ln_g": torch.ones(d_model, device=device),
        # channel mix
        "mu_c": torch.full((d_model,), 0.5, device=device),
        "ck": lin(d_model, d_ff),
        "cv": lin(d_ff, d_model),
        "cr": lin(d_model, d_model),
    }


def _token_shift(x, prev, mu, impl: str = "auto"):
    """lerp(x_{t-1}, x_t, mu) with x_{-1} = prev (b, 1, d), or 0 when prev
    is None: a depthwise causal conv with taps (1 - mu, mu), mu rounded to
    x's dtype as ``repro`` rounds it.  A carried prev is prepended and its
    own row dropped from the output."""
    m = mu.to(x.dtype).float()
    w = torch.stack([1.0 - m, m])                              # (2, d)
    if prev is None:
        return ops.conv1d_causal(x, w, impl=impl)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    return ops.conv1d_causal(xp, w, impl=impl)[:, 1:]


def _io(z):
    """A chunked einsum operand: under ``perf.bf16_attn_io`` rounded to
    bf16 (``repro``'s operands, whatever the activations' dtype) and used
    in fp32; else z itself."""
    return z.to(torch.bfloat16).float() if perf.get().bf16_attn_io else z


def _wkv_chunked(r, k, v, log_decay, u, state, chunk: int):
    """Chunked-parallel WKV6 (GLA-style).

    r/k/v/log_decay: (b, T, H, D) fp32; u: (H, D); state: (b, H, D, E) fp32.
    Per chunk, with C the inclusive cumsum of log_decay (<= 0) and E the
    exclusive one, the intra-chunk weights are
    ``A[t, i] = (r e^E)(k e^-C)^T`` for i < t; ``e^-C`` is clipped at
    ``e^30`` (error only where the true weight underflows to zero anyway).
    Under ``perf.bf16_attn_io`` ``repro`` multiplies bf16 operands with
    fp32 accumulation (``preferred_element_type``): here the operands are
    rounded to bf16 and multiplied in fp32, where a bf16 matmul would round
    its output.
    Returns ((b, T, H, E), final state).
    """
    b, t, h, d = r.shape
    e_dim = v.shape[-1]
    nc = t // chunk
    rc, kc, wc = (z.reshape(b, nc, chunk, h, d) for z in (r, k, log_decay))
    vc = v.reshape(b, nc, chunk, h, e_dim)

    C = torch.cumsum(wc, dim=2)                      # inclusive (b,nc,L,H,D)
    E = C - wc                                       # exclusive
    r_tilde = rc * torch.exp(E)
    k_tilde = kc * torch.exp(torch.clamp(-C, max=30.0))
    k_hat = kc * torch.exp(C[:, :, -1:] - C)         # <= 1, safe
    v_io = _io(vc)

    # intra-chunk: strict-lower-triangular attention + diagonal u bonus
    A = torch.einsum("bcthd,bcihd->bchti", _io(r_tilde), _io(k_tilde))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), diagonal=-1)
    A = torch.where(tri, A, 0.0)
    y = torch.einsum("bchti,bcihe->bcthe", _io(A), v_io)
    diag = torch.einsum("bcthd,hd->bcth", rc * kc, u)
    y = y + diag[..., None] * vc

    # inter-chunk: a loop over the chunks carrying the state
    decay_chunk = torch.exp(C[:, :, -1])             # (b,nc,H,D)
    states = torch.einsum("bcihd,bcihe->bchde", _io(k_hat), v_io)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bthd,bhde->bthe", r_tilde[:, c], state))
        state = state * decay_chunk[:, c][..., None] + states[:, c]
    y = y + torch.stack(y_inter, dim=1)
    return y.reshape(b, t, h, e_dim), state


def _wkv_step(state, rt, kt, vt, ld, u):
    """One token of the WKV6 recurrence: rt/kt/vt/ld (b, H, D)."""
    kv = torch.einsum("bhk,bhv->bhkv", kt, vt)                  # (b,H,dk,dv)
    out = torch.einsum("bhk,bhkv->bhv", rt, state + u[None, :, :, None] * kv)
    return state * torch.exp(ld)[..., None] + kv, out


def _wkv_recurrent(r, k, v, log_decay, u, state):
    """The per-token WKV6 recurrence (decode, T off the chunk, and every T
    without ``perf.rwkv_chunked``), fp32, a ``loops.scan`` over the tokens
    (``repro``'s ``lax.scan``).  Returns ((b, T, H, E), final state)."""
    state, out = loops.scan(_wkv_step, state, (r, k, v, log_decay), (u,))
    return out, state


def rwkv6_time_mix(params, x, prev_x, state, *, n_heads: int,
                   impl: str = "auto"):
    """WKV6 recurrence.  x: (b, T, d); prev_x: (b, 1, d) or None (zeros);
    state: (b, H, dk, dv) fp32.  Returns (out, last_x, new_state)."""
    b, t, d = x.shape
    dh = d // n_heads
    xs = _token_shift(x, prev_x, params["mu_x"], impl)

    r = dense(params["wr"], xs, x.dtype).reshape(b, t, n_heads, dh)
    k = dense(params["wk"], xs, x.dtype).reshape(b, t, n_heads, dh)
    v = dense(params["wv"], xs, x.dtype).reshape(b, t, n_heads, dh)
    g = dense(params["wg"], xs, x.dtype)

    # data-dependent decay (the Finch contribution)
    wlow = torch.tanh(xs.float() @ params["wA"]) @ params["wB"]
    w = params["w0"] + wlow                                    # (b,T,d)
    log_decay = -torch.exp(w.reshape(b, t, n_heads, dh))       # <= 0

    rf, kf, vf = r.float(), k.float(), v.float()
    pc = perf.get()
    c = min(pc.rwkv_chunk, t)
    if pc.rwkv_chunked and t > 1 and t % c == 0:
        out, state = _wkv_chunked(rf, kf, vf, log_decay, params["u"], state,
                                  c)
    else:
        out, state = _wkv_recurrent(rf, kf, vf, log_decay, params["u"],
                                    state)
    out = out.reshape(b, t, d)

    # group-norm-ish over d + silu(g) gate, in fp32
    rms = torch.rsqrt(torch.mean(out * out, dim=-1, keepdim=True) + 1e-6)
    out = out * rms * params["ln_g"]
    out = (out * F.silu(g.float())).to(x.dtype)
    return dense(params["wo"], out, x.dtype), x[:, -1:], state


def rwkv6_channel_mix(params, x, prev_x, *, impl: str = "auto"):
    """x: (b, T, d); prev_x: (b, 1, d) or None.  Returns (out, last_x)."""
    xs = _token_shift(x, prev_x, params["mu_c"], impl)
    k = dense(params["ck"], xs, x.dtype)
    k = torch.square(F.relu(k.float())).to(x.dtype)
    r = torch.sigmoid(dense(params["cr"], xs, x.dtype).float())
    return ((r * dense(params["cv"], k, x.dtype).float()).to(x.dtype),
            x[:, -1:])
