"""Shared model layers: norms, FFNs, embeddings (port of ``repro.models.layers``).

Plain functions over parameter dicts with ``repro``'s keys.  Params are
stored fp32 (the master dtype); the forward computes in the activation's
dtype (bf16 in the LMs).  ``repro``'s ``dense`` casts the fp32 weight to the
compute dtype at every call.  Here a dense dict may also hold that cast once,
under ``"wc"`` (``with_compute_copies``): the values are the same bits, since
the cast is elementwise and deterministic, so either form gives the same
product.  Initialisers draw from an explicit ``torch.Generator``
on the generator's own device and move the result to ``device``: a CUDA
generator draws full-width weights on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """fp32 N(0, std^2) drawn from ``gen`` on its device, placed on ``device``."""
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std).to(
        device)


def dense_init(gen, d_in: int, d_out: int, scale: float | None = None, *,
               device="cpu"):
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": normal(gen, (d_in, d_out), scale, device)}


def dense(params, x, dtype=torch.bfloat16):
    wc = params.get("wc")
    w = wc if wc is not None and wc.dtype == dtype else params["w"].to(dtype)
    return x @ w


def rmsnorm_init(d: int, *, device="cpu"):
    return {"g": torch.ones(d, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * rms) * params["g"]).to(x.dtype)


def ffn_init(gen, d: int, d_ff: int, gated: bool = True, *, device="cpu"):
    if gated:
        return {"wi": dense_init(gen, d, d_ff, device=device),
                "wg": dense_init(gen, d, d_ff, device=device),
                "wo": dense_init(gen, d_ff, d, device=device)}
    return {"wi": dense_init(gen, d, d_ff, device=device),
            "wo": dense_init(gen, d_ff, d, device=device)}


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ffn(params, x, activation: str = "silu"):
    """SwiGLU/GeGLU when 'wg' present; plain GELU MLP otherwise."""
    dtype = x.dtype
    h = dense(params["wi"], x, dtype)
    if "wg" in params:
        act = F.silu if activation == "silu" else gelu
        h = act(dense(params["wg"], x, dtype).float()).to(dtype) * h
    else:
        h = gelu(h.float()).to(dtype)
    return dense(params["wo"], h, dtype)


def embedding_init(gen, vocab: int, d: int, *, device="cpu"):
    return {"e": normal(gen, (vocab, d), 0.02, device)}


def embed(params, tokens, dtype=torch.bfloat16):
    """Rows of the table in ``dtype``: gather first, then cast (same values
    as casting the whole table first, as ``repro`` does)."""
    ec = params.get("ec")
    if ec is not None and ec.dtype == dtype:
        return ec[tokens]
    return params["e"][tokens].to(dtype)


def unembed(params, x):
    """Tied output head: (B, T, d) @ (d, V)."""
    return x @ table(params, x.dtype).T


def table(params, dtype):
    """The embedding table in ``dtype`` (the held copy when there is one)."""
    ec = params.get("ec")
    return ec if ec is not None and ec.dtype == dtype else \
        params["e"].to(dtype)


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


COMPUTE_COPY_KEYS = frozenset({"wc", "ec", "wi_c", "wg_c", "wo_c"})


def with_compute_copies(params, dtype=torch.bfloat16):
    """Add a ``dtype`` copy of every dense weight (``"wc"``), of the
    embedding table (``"ec"``) and of an MoE layer's stacked expert weights
    (``"wi_c"``, ``"wg_c"``, ``"wo_c"``; an MoE dict is the one with a
    ``"router"``), made once: ``COMPUTE_COPY_KEYS``.

    The copies are for serving only.  ``dense``, ``embed``, ``table`` and
    ``moe.expert_weight`` prefer a copy over its master, so a gradient would
    land on the copy and an optimizer step would leave it stale:
    ``lm.forward_train`` refuses params that hold one.

    ``repro`` casts the fp32 weights at every use; the copies hold the same
    values, so the forward's results do not change, only the per-call casts
    go (about 4.7 GB of bf16 beside zamba2-2.7b's 9.4 GB of fp32; without
    the expert copies every mixtral-8x7b decode step would cast 5.6 GB of
    fp32 experts per layer).
    """
    if not isinstance(params, dict):
        return params
    out = {k: with_compute_copies(v, dtype) for k, v in params.items()}
    if isinstance(params.get("w"), torch.Tensor):
        out["wc"] = params["w"].to(dtype)
    if isinstance(params.get("e"), torch.Tensor):
        out["ec"] = params["e"].to(dtype)
    if isinstance(params.get("router"), torch.Tensor):
        for name in ("wi", "wg", "wo"):
            out[name + "_c"] = params[name].to(dtype)
    return out
