"""Decoder LM: prefill and decode for the attention and Mamba2 stacks
(port of ``repro.models.lm``).

A network is a stack of *groups*, each a short static sequence of block
templates (gemma2's local/global alternation, zamba2's shared-attention
period).  Parameters keep ``repro``'s pytree as nested dicts: every
``params["blocks"]["p<i>"]`` leaf carries a leading group axis, and where
``repro`` scans over groups (``lax.scan``) this module loops over that axis
in Python.  The cache has the same layout, and ``decode_step`` updates it in
place (``repro`` returns a new one).

zamba2's shared attention block: ONE set of attention+FFN weights applied
after every group of Mamba2 blocks, with a per-group KV cache.

Entry points: ``init_params`` (random weights drawn on the target device;
``layers.with_compute_copies`` adds a bf16 copy of every dense weight),
``init_cache``, ``prefill`` and ``decode_step``.  ``impl`` selects the
kernels (``"cuda"``), their plain versions (``"ref"``) or by device
(``"auto"``), as ``kernels.ops`` does.  ``dtype`` is the activations' and
caches' dtype, ``COMPUTE_DTYPE`` (bf16) as in ``repro``; an fp32 run of the
plain engine is the reference the bf16 engines are measured against.  Every
attention cache holds ``max_seq`` rows (``repro``'s ``windowed_local_cache``
shortens windowed layers' caches, whose decode is not ported).  Not ported
yet (ROADMAP.md): MoE blocks, RWKV-6 blocks, ``forward_train`` and
``loss_fn``, sharding hints.
"""
from __future__ import annotations

from typing import Any

import torch

from . import attention as attn_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .convert import resolve_device, tree_map
from .layers import (
    dense,
    embed,
    embedding_init,
    ffn,
    ffn_init,
    normal,
    rmsnorm,
    rmsnorm_init,
    softcap,
    table,
)

Params = Any
COMPUTE_DTYPE = torch.bfloat16   # activations and KV caches
_NOT_PORTED = ("{what} blocks are not ported to repro_torch yet "
               "(ROADMAP.md, Queue 1)")


def _place_kv(buf, kv) -> None:
    """Write prefill KV (B, T, Kh, dh) into one group's (B, S, Kh, dh) cache."""
    buf[:, :kv.shape[1]] = kv


# ----------------------------- block templates -------------------------------
def _group_templates(cfg: ModelConfig) -> list[dict]:
    """Static description of the blocks inside one group."""
    out = []
    for p in range(cfg.group_size):
        if cfg.block_type == "attn":
            is_local = cfg.local_global_period > 1 and (
                p % cfg.local_global_period == 0)
            is_moe = cfg.is_moe and (
                cfg.moe_period == 1 or p % cfg.moe_period == cfg.moe_period - 1)
            out.append({"kind": "attn", "is_local": is_local, "is_moe": is_moe})
        elif cfg.block_type in ("rwkv6", "mamba2"):
            out.append({"kind": cfg.block_type})
        else:
            raise ValueError(cfg.block_type)
    return out


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(_NOT_PORTED.format(what=f"{cfg.name}: MoE"))
    if cfg.block_type == "rwkv6":
        raise NotImplementedError(_NOT_PORTED.format(what=f"{cfg.name}: RWKV-6"))


# ------------------------------- init ----------------------------------------
def _init_block(cfg: ModelConfig, spec: dict, gen, dev) -> Params:
    if spec["kind"] == "attn":
        p = {"ln1": rmsnorm_init(cfg.d_model, device=dev),
             "attn": attn_mod.attention_init(
                 gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                 device=dev),
             "ln2": rmsnorm_init(cfg.d_model, device=dev)}
        if cfg.post_norm:
            p["ln1p"] = rmsnorm_init(cfg.d_model, device=dev)
            p["ln2p"] = rmsnorm_init(cfg.d_model, device=dev)
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff,
                            gated=cfg.ffn_type in ("swiglu", "geglu"),
                            device=dev)
        return p
    return {"ln1": rmsnorm_init(cfg.d_model, device=dev),
            "mamba": ssm_mod.mamba2_init(gen, cfg.d_model, cfg.ssm_state,
                                         head_dim=cfg.ssm_head_dim,
                                         d_conv=cfg.d_conv, device=dev)}


def _stack(trees: list):
    """Stack a list of equal nested dicts along a new leading (group) axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *,
                device="cuda") -> Params:
    """Random fp32 weights with ``repro``'s shapes, scales and pytree.

    Drawn from ``generator`` on its own device (default: a generator seeded
    0 on ``device``), so a CUDA generator makes full-width weights on the
    card.  The default CUDA device raises without a card.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    blocks = {}
    for p, spec in enumerate(_group_templates(cfg)):
        blocks[f"p{p}"] = _stack([_init_block(cfg, spec, gen, dev)
                                  for _ in range(cfg.n_groups)])
    params = {"embed": embedding_init(gen, cfg.vocab, cfg.d_model, device=dev),
              "final_norm": rmsnorm_init(cfg.d_model, device=dev),
              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["head"] = {"w": normal(gen, (cfg.d_model, cfg.vocab),
                                      cfg.d_model ** -0.5, dev)}
    if cfg.hybrid_attn_period:   # zamba2 shared attention+FFN block
        params["shared_attn"] = {
            "ln1": rmsnorm_init(cfg.d_model, device=dev),
            "attn": attn_mod.attention_init(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                device=dev),
            "ln2": rmsnorm_init(cfg.d_model, device=dev),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, gated=True,
                            device=dev),
        }
    return params


# ----------------------------- block forward ---------------------------------
def _attn_kwargs(cfg: ModelConfig, spec: dict) -> dict:
    window = cfg.window if (cfg.local_global_period <= 1 or spec["is_local"]) \
        else 0
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_head=cfg.d_head, rope_theta=cfg.rope_theta,
                window=window, attn_softcap=cfg.attn_softcap,
                mrope_sections=cfg.mrope_sections)


def _apply_ffn_part(cfg, bp, x):
    """FFN half of an attn block (dense FFN; MoE is not ported)."""
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    y = ffn(bp["ffn"], h, activation="gelu" if cfg.ffn_type == "geglu"
            else "silu")
    if cfg.post_norm:
        y = rmsnorm(bp["ln2p"], y, cfg.norm_eps)
    return y


def _apply_block_full(cfg, spec, bp, x, impl):
    """Full-sequence block.  Returns (x, cache entry)."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if spec["kind"] == "attn":
        y, (k, v) = attn_mod.attention(bp["attn"], h, impl=impl,
                                       **_attn_kwargs(cfg, spec))
        if cfg.post_norm:
            y = rmsnorm(bp["ln1p"], y, cfg.norm_eps)
        x = x + y
        return x + _apply_ffn_part(cfg, bp, x), {"k": k, "v": v}
    y, (s, cs) = ssm_mod.mamba2(bp["mamba"], h, d_state=cfg.ssm_state,
                                head_dim=cfg.ssm_head_dim, return_state=True,
                                impl=impl)
    return x + y, {"ssm": s, "conv": cs}


_SHARED_SPEC = {"kind": "attn", "is_local": False, "is_moe": False}


def _apply_shared_attn_full(cfg, sp, x, impl):
    h = rmsnorm(sp["ln1"], x, cfg.norm_eps)
    y, (k, v) = attn_mod.attention(sp["attn"], h, impl=impl,
                                   **_attn_kwargs(cfg, _SHARED_SPEC))
    x = x + y
    x = x + ffn(sp["ffn"], rmsnorm(sp["ln2"], x, cfg.norm_eps))
    return x, {"k": k, "v": v}


# ----------------------------- full forward ----------------------------------
def _embed_in(cfg: ModelConfig, params, batch, key: str, dtype):
    if cfg.input_mode == "embeds":
        return batch["embeds"].to(dtype)
    return embed(params["embed"], batch[key], dtype)


def _logits(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        logits = h @ table(params["embed"], h.dtype).T
    else:
        logits = dense(params["head"], h, h.dtype)
    return softcap(logits, cfg.final_softcap)


def _group(tree, g: int):
    """Group g's slice of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[g], tree)


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *,
               device="cuda", dtype=COMPUTE_DTYPE) -> Params:
    """Zeroed decode cache matching the group/block structure."""
    _check_ported(cfg)
    dev = resolve_device(device)
    g, b, dh = cfg.n_groups, batch_size, cfg.d_head

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = {}
    for p, spec in enumerate(_group_templates(cfg)):
        if spec["kind"] == "attn":
            c = {n: zeros(g, b, max_seq, cfg.n_kv_heads, dh, dtype=dtype)
                 for n in ("k", "v")}
        else:
            d_inner = 2 * cfg.d_model
            n_h = d_inner // cfg.ssm_head_dim
            d_xbc = d_inner + 2 * cfg.ssm_state
            c = {"ssm": zeros(g, b, n_h, cfg.ssm_state, cfg.ssm_head_dim),
                 "conv": zeros(g, b, cfg.d_conv - 1, d_xbc)}
        cache[f"p{p}"] = c
    if cfg.hybrid_attn_period:
        cache["shared"] = {n: zeros(g, b, max_seq, cfg.n_kv_heads, dh,
                                    dtype=dtype) for n in ("k", "v")}
    return cache


def prefill(cfg: ModelConfig, params: Params, batch, max_seq: int, *,
            impl: str = "auto", dtype=COMPUTE_DTYPE) -> tuple:
    """Full-sequence forward returning (last-position logits, cache)."""
    templates = _group_templates(cfg)
    x = _embed_in(cfg, params, batch, "tokens", dtype)
    cache = init_cache(cfg, x.shape[0], max_seq, device=x.device, dtype=dtype)
    for g in range(cfg.n_groups):
        for p, spec in enumerate(templates):
            key = f"p{p}"
            x, c = _apply_block_full(cfg, spec, _group(params["blocks"][key], g),
                                     x, impl)
            if spec["kind"] == "attn":
                for n in ("k", "v"):
                    _place_kv(cache[key][n][g], c[n])
            else:
                for n in ("ssm", "conv"):
                    cache[key][n][g].copy_(c[n])
        if cfg.hybrid_attn_period:
            x, cs = _apply_shared_attn_full(cfg, params["shared_attn"], x,
                                            impl)
            for n in ("k", "v"):
                _place_kv(cache["shared"][n][g], cs[n])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x[:, -1:]), cache


# ------------------------------ decode step ----------------------------------
def _apply_block_decode(cfg, spec, bp, x, c, pos, impl):
    """One-token block step; updates c (this block's cache slice) in place."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if spec["kind"] == "attn":
        y, _, _ = attn_mod.attention_decode(
            bp["attn"], h, c["k"], c["v"], pos, impl=impl,
            **_attn_kwargs(cfg, spec))
        if cfg.post_norm:
            y = rmsnorm(bp["ln1p"], y, cfg.norm_eps)
        x = x + y
        return x + _apply_ffn_part(cfg, bp, x)
    y, s, cs = ssm_mod.mamba2_decode(bp["mamba"], h, c["ssm"], c["conv"],
                                     d_state=cfg.ssm_state,
                                     head_dim=cfg.ssm_head_dim)
    c["ssm"].copy_(s)
    c["conv"].copy_(cs)
    return x + y


def decode_step(cfg: ModelConfig, params: Params, batch, cache, *,
                impl: str = "auto", dtype=COMPUTE_DTYPE) -> tuple:
    """One decode step.  batch: {"token": (B,1) or "embeds": (B,1,d),
    "pos": (B,)}.  Returns (logits (B,1,V), cache), the cache updated in
    place."""
    templates = _group_templates(cfg)
    pos = batch["pos"]
    x = _embed_in(cfg, params, batch, "token", dtype)
    for g in range(cfg.n_groups):
        for p, spec in enumerate(templates):
            key = f"p{p}"
            x = _apply_block_decode(cfg, spec, _group(params["blocks"][key], g),
                                    x, _group(cache[key], g), pos, impl)
        if cfg.hybrid_attn_period:
            sp = params["shared_attn"]
            h = rmsnorm(sp["ln1"], x, cfg.norm_eps)
            y, _, _ = attn_mod.attention_decode(
                sp["attn"], h, cache["shared"]["k"][g],
                cache["shared"]["v"][g], pos, impl=impl,
                **_attn_kwargs(cfg, _SHARED_SPEC))
            x = x + y
            x = x + ffn(sp["ffn"], rmsnorm(sp["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x), cache
