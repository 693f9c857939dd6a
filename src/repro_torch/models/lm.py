"""Decoder LM: training, prefill and decode for all ten architectures (port
of ``repro.models.lm``): attention blocks (dense FFN, MoE, MoE with a shared
expert), Mamba2 blocks with zamba2's shared attention, and RWKV-6 blocks.

A network is a stack of *groups*, each a short static sequence of block
templates (gemma2's local/global alternation, llama4's interleaved MoE,
zamba2's shared-attention period).  Parameters keep ``repro``'s pytree as
nested dicts: every ``params["blocks"]["p<i>"]`` leaf carries a leading
group axis, and where ``repro`` scans over groups (``lax.scan``) this
module loops over that axis in Python.  The cache has the same layout, and
``decode_step`` updates it in place (``repro`` returns a new one).

zamba2's shared attention block: ONE set of attention+FFN weights applied
after every group of Mamba2 blocks, with a per-group KV cache.

Entry points: ``init_params`` (random weights drawn on the target device;
``layers.with_compute_copies`` adds a bf16 copy of every dense weight, for
serving), ``forward_train`` and ``loss_fn`` (training), ``init_cache``,
``prefill`` and ``decode_step``.  ``impl`` selects the
kernels (``"cuda"``), their plain versions (``"ref"``) or by device
(``"auto"``), as ``kernels.ops`` does.  ``dtype`` is the activations' and
caches' dtype, ``COMPUTE_DTYPE`` (bf16) as in ``repro``; an fp32 run of the
plain engine is the reference the bf16 engines are measured against.  As in
``repro``, under ``perf.windowed_local_cache`` (the default) a
sliding-window layer's cache is a ring of ``min(window, max_seq)`` slots
holding position p in slot p % W (``_attn_cache_len``, ``_place_kv``), and
every other attention cache holds ``max_seq`` rows; without the flag (the
paper-faithful baseline) every attention cache holds ``max_seq`` rows
written linearly, and decode masks the window over it.  The flag is read
when a cache is made (``init_cache``, ``prefill``) and at every decode
step, which must see the state the cache was made under.  Serving drops
the MoE layers' load-balancing loss, as ``repro``'s prefill does;
training adds it, ``0.01 * aux``.

Training (``forward_train``, ``loss_fn``) differentiates with autograd.  The
flash and conv1d wrappers are autograd Functions (the kernels forward, the
plain versions' gradients backward), so ``impl="cuda"``/``"auto"`` on the card
trains through the kernels.  With ``cfg.remat`` every group runs under
``torch.utils.checkpoint`` (``repro``'s ``jax.checkpoint`` of the scanned
group body), so its forward runs again in the backward; the cross-entropy
goes by ``cfg.loss_chunk`` positions, each chunk checkpointed, its logits in
fp32.  Training takes the fp32 masters alone: params holding compute copies
raise, since gradients would land on the copies.

Under a sharded step (``launch.steps``) the same functions run on each
device's own tokens: ``sharding_hints.local_tokens`` says how they are laid
out, weights are all-gathered on use (``sharding_hints.gather_params``,
DTensor leaves; per group in the loop), the recurrent mixers see the whole
sequence (gathered before the mixing, this shard's rows kept after: one
all-gather a block), the caches are each device's shards (the KV caches'
rows by ``kv_offset``), the prefill's last position comes from the last
sequence shard, and the loss and the MoE balance loss are each device's
share of the global mean (summed over devices by the step).  Without a
layout every one of these is the identity.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .. import perf
from . import attention as attn_mod
from . import moe as moe_mod
from . import sharding_hints as hints
from . import ssm as ssm_mod
from .config import ModelConfig
from .convert import resolve_device
from .layers import (
    COMPUTE_COPY_KEYS,
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


def _attn_cache_len(cfg: ModelConfig, spec: dict, max_seq: int) -> int:
    """Under ``perf.windowed_local_cache`` sliding-window layers keep a
    rolling window-sized cache (never store or read keys the window mask
    cannot use); the others, and every layer without the flag,
    ``max_seq``."""
    if not perf.get().windowed_local_cache:
        return max_seq
    w = _attn_kwargs(cfg, spec)["window"]
    return min(w, max_seq) if w and w > 0 else max_seq


def _place_kv_shard(buf, kv, rows: int) -> None:
    """``_place_kv`` into this device's rows of a cache of ``rows`` slots
    (the whole buffer unsharded)."""
    if buf.shape[1] == rows:
        _place_kv(buf, kv)
        return
    full = kv.new_zeros((kv.shape[0], rows) + tuple(kv.shape[2:]))
    _place_kv(full, kv)
    s0 = hints.kv_offset(buf.shape[1])
    buf.copy_(full[:, s0:s0 + buf.shape[1]])


def _place_kv(buf, kv) -> None:
    """Write prefill KV (B, T, Kh, dh) into one group's (B, W, Kh, dh) cache.

    With T <= W the tokens take slots 0..T-1; a rolling buffer (W < T) gets
    the last W tokens at slots pos % W, the tail rolled by (T - W) % W."""
    w, t = buf.shape[1], kv.shape[1]
    if t <= w:
        buf[:, :t] = kv
    else:
        buf.copy_(torch.roll(kv[:, t - w:], (t - w) % w, dims=1))


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
        if spec["is_moe"]:
            p["moe"] = moe_mod.moe_init(gen, cfg.n_experts, cfg.d_model,
                                        cfg.d_ff, device=dev)
            if cfg.n_shared_experts:
                p["shared_ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff,
                                           gated=True, device=dev)
        else:
            p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff,
                                gated=cfg.ffn_type in ("swiglu", "geglu"),
                                device=dev)
        return p
    if spec["kind"] == "rwkv6":
        return {"ln1": rmsnorm_init(cfg.d_model, device=dev),
                "ln2": rmsnorm_init(cfg.d_model, device=dev),
                "mix": ssm_mod.rwkv6_init(gen, cfg.d_model, cfg.n_heads,
                                          d_ff=cfg.d_ff, device=dev)}
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


def _apply_ffn_part(cfg, spec, bp, x):
    """FFN / MoE half of an attn block.  Returns (delta, the MoE's aux loss
    or None); serving drops the aux loss."""
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    aux = None
    if spec["is_moe"]:
        y, aux = moe_mod.moe_ffn(bp["moe"], h, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor)
        if cfg.n_shared_experts:
            y = y + ffn(bp["shared_ffn"], h, activation="silu")
    else:
        y = ffn(bp["ffn"], h, activation="gelu" if cfg.ffn_type == "geglu"
                else "silu")
    if cfg.post_norm:
        y = rmsnorm(bp["ln2p"], y, cfg.norm_eps)
    return y, aux


def _rwkv6_block(cfg, bp, x, c, impl):
    """An RWKV-6 block over x (B, T, d) from the carried state c (None:
    zeros, as in prefill).  Returns (x, cache entry)."""
    b = x.shape[0]
    if c is None:
        dh = cfg.d_model // cfg.n_heads
        c = {"wkv": torch.zeros((b, cfg.n_heads, dh, dh), device=x.device),
             "sx_t": None, "sx_c": None}
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    y, last_t, s = ssm_mod.rwkv6_time_mix(bp["mix"], h, c["sx_t"], c["wkv"],
                                          n_heads=cfg.n_heads, impl=impl)
    x = x + y
    h2 = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    y2, last_c = ssm_mod.rwkv6_channel_mix(bp["mix"], h2, c["sx_c"],
                                           impl=impl)
    return x + y2, {"wkv": s, "sx_t": last_t.float(),
                    "sx_c": last_c.float()}


def _apply_block_full(cfg, spec, bp, x, impl, want_cache: bool = True):
    """Full-sequence block.  Returns (x, cache entry or None, the MoE's aux
    loss or None); training passes ``want_cache=False`` and builds no
    cache."""
    if spec["kind"] == "rwkv6":
        # the token shifts and the WKV scan need the whole sequence
        x, c = _rwkv6_block(cfg, bp, hints.gather_seq(x), None, impl)
        return hints.local_rows(x), (c if want_cache else None), None
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if spec["kind"] == "attn":
        y, (k, v) = attn_mod.attention(bp["attn"], h, impl=impl,
                                       **_attn_kwargs(cfg, spec))
        if cfg.post_norm:
            y = rmsnorm(bp["ln1p"], y, cfg.norm_eps)
        x = x + y
        y, aux = _apply_ffn_part(cfg, spec, bp, x)
        return x + y, ({"k": k, "v": v} if want_cache else None), aux
    kw = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, impl=impl)
    h = hints.gather_seq(h)        # the conv and the scan: whole sequence
    if not want_cache:
        y = ssm_mod.mamba2(bp["mamba"], h, **kw)
        return x + hints.local_rows(y), None, None
    y, (s, cs) = ssm_mod.mamba2(bp["mamba"], h, return_state=True, **kw)
    return x + hints.local_rows(y), {"ssm": s, "conv": cs}, None


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
    """This device's tokens embedded (its rows of the sequence)."""
    if cfg.input_mode == "embeds":
        return hints.local_rows(batch["embeds"]).to(dtype)
    return embed(params["embed"], hints.local_rows(batch[key]), dtype)


def _logits(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        logits = h @ table(params["embed"], h.dtype).T
    else:
        logits = dense(params["head"], h, h.dtype)
    return softcap(logits, cfg.final_softcap)


def _group(tree, g: int):
    """Group g's slice of a stacked tree (views, no copies; gathered where
    the leaves are sharded DTensors)."""
    return hints.gather_params(tree, g)


_TOP = ("embed", "final_norm", "head", "shared_attn")


def _top(params) -> dict:
    """The weights outside the group stack, gathered for use (the params
    themselves unsharded); "blocks" as it is."""
    return {k: (hints.gather_params(v) if k in _TOP else v)
            for k, v in params.items()}


def _no_compute_copies(params) -> None:
    """Training differentiates the fp32 masters: a compute copy would take
    the gradient in their place and go stale after the update."""
    def walk(tree, path):
        for k, v in tree.items():
            if k in COMPUTE_COPY_KEYS:
                raise ValueError(
                    f"forward_train: params hold the compute copy "
                    f"{'/'.join(path + [k])}; train on the fp32 masters "
                    "alone (lm_params_from_numpy(..., compute_copies=False))")
            if isinstance(v, dict):
                walk(v, path + [k])
    walk(params, [])


def forward_train(cfg: ModelConfig, params: Params, batch, *,
                  impl: str = "auto", dtype=COMPUTE_DTYPE) -> tuple:
    """Full-sequence training forward.  Returns (hidden (B, T, d), the MoE
    layers' summed aux loss, an fp32 0-d tensor).

    Under autograd with ``cfg.remat`` each group is checkpointed (its
    forward runs again in the backward, kernels included)."""
    _no_compute_copies(params)
    templates = _group_templates(cfg)
    params = _top(params)
    x = _embed_in(cfg, params, batch, "tokens", dtype)

    def group_body(x, aux, g):
        for p, spec in enumerate(templates):
            x, _, a = _apply_block_full(
                cfg, spec, _group(params["blocks"][f"p{p}"], g), x, impl,
                want_cache=False)
            if a is not None:
                aux = aux + a
        if cfg.hybrid_attn_period:
            x, _ = _apply_shared_attn_full(cfg, params["shared_attn"], x,
                                           impl)
        return x, aux

    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        if remat:
            x, aux = checkpoint(group_body, x, aux, g, use_reentrant=False)
        else:
            x, aux = group_body(x, aux, g)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _chunk_nll(cfg: ModelConfig, params, hc, lc):
    """Summed negative log-likelihood of one chunk, from fp32 logits."""
    logits = _logits(cfg, params, hc).float()                 # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def loss_fn(cfg: ModelConfig, params: Params, batch, *, impl: str = "auto",
            dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``0.01 * aux``.  The (B, T, V)
    logits never exist whole: ``cfg.loss_chunk`` positions at a time, each
    chunk checkpointed under autograd (a tail short of a chunk is dropped,
    as in ``repro``).  Under a sharded step, this device's share: its
    tokens' summed loss over the global count, plus its share of aux."""
    h, aux = forward_train(cfg, params, batch, impl=impl, dtype=dtype)
    params = _top(params)
    labels = batch["labels"]
    b, t = labels.shape
    chunk = min(cfg.loss_chunk, t)
    n_chunks = t // chunk
    labels = hints.local_rows(labels)
    t0 = hints.seq_offset(labels.shape[1])
    end = min(max(n_chunks * chunk - t0, 0), labels.shape[1])
    total = torch.zeros((), device=h.device)
    for i0 in range(0, end, chunk):
        hc = h[:, i0:min(i0 + chunk, end)]
        lc = labels[:, i0:min(i0 + chunk, end)]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, cfg, params, hc, lc,
                                       use_reentrant=False)
        else:
            total = total + _chunk_nll(cfg, params, hc, lc)
    b *= hints.batch_shards()
    return total / (b * n_chunks * chunk) + 0.01 * aux


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *,
               device="cuda", dtype=COMPUTE_DTYPE) -> Params:
    """Zeroed decode cache matching the group/block structure."""
    return _init_cache(cfg, batch_size, max_seq, resolve_device(device),
                       dtype)


def _init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dev,
                dtype, kv_shards: int = 1) -> Params:
    """``init_cache`` with each KV cache's rows cut into ``kv_shards``
    (this device's shard under a sharded step)."""
    g, b, dh = cfg.n_groups, batch_size, cfg.d_head

    def rows(n: int) -> int:
        if n % kv_shards:
            raise ValueError(f"a KV cache of {n} rows does not split into "
                             f"{kv_shards} shards")
        return n // kv_shards

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = {}
    for p, spec in enumerate(_group_templates(cfg)):
        if spec["kind"] == "attn":
            s_p = rows(_attn_cache_len(cfg, spec, max_seq))
            c = {n: zeros(g, b, s_p, cfg.n_kv_heads, dh, dtype=dtype)
                 for n in ("k", "v")}
        elif spec["kind"] == "rwkv6":
            hd = cfg.d_model // cfg.n_heads
            c = {"wkv": zeros(g, b, cfg.n_heads, hd, hd),
                 "sx_t": zeros(g, b, 1, cfg.d_model),
                 "sx_c": zeros(g, b, 1, cfg.d_model)}
        else:
            d_inner = 2 * cfg.d_model
            n_h = d_inner // cfg.ssm_head_dim
            d_xbc = d_inner + 2 * cfg.ssm_state
            c = {"ssm": zeros(g, b, n_h, cfg.ssm_state, cfg.ssm_head_dim),
                 "conv": zeros(g, b, cfg.d_conv - 1, d_xbc)}
        cache[f"p{p}"] = c
    if cfg.hybrid_attn_period:
        cache["shared"] = {n: zeros(g, b, rows(max_seq), cfg.n_kv_heads,
                                    dh, dtype=dtype) for n in ("k", "v")}
    return cache


def prefill(cfg: ModelConfig, params: Params, batch, max_seq: int, *,
            impl: str = "auto", dtype=COMPUTE_DTYPE) -> tuple:
    """Full-sequence forward returning (last-position logits, cache)."""
    templates = _group_templates(cfg)
    params = _top(params)
    x = _embed_in(cfg, params, batch, "tokens", dtype)
    cache = _init_cache(cfg, x.shape[0], max_seq, x.device, dtype,
                        hints.kv_shards())
    for g in range(cfg.n_groups):
        for p, spec in enumerate(templates):
            key = f"p{p}"
            x, c, _ = _apply_block_full(
                cfg, spec, _group(params["blocks"][key], g), x, impl)
            if spec["kind"] == "attn":
                rows = _attn_cache_len(cfg, spec, max_seq)
                for n in ("k", "v"):
                    _place_kv_shard(cache[key][n][g], c[n], rows)
            else:
                for n, t in c.items():
                    cache[key][n][g].copy_(t)
        if cfg.hybrid_attn_period:
            x, cs = _apply_shared_attn_full(cfg, params["shared_attn"], x,
                                            impl)
            for n in ("k", "v"):
                _place_kv_shard(cache["shared"][n][g], cs[n], max_seq)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, hints.last_row(x)), cache


# ------------------------------ decode step ----------------------------------
def _apply_block_decode(cfg, spec, bp, x, c, pos, impl):
    """One-token block step; updates c (this block's cache slice) in place."""
    if spec["kind"] == "rwkv6":
        x, nc = _rwkv6_block(cfg, bp, x, c, impl)
        for n, t in nc.items():
            c[n].copy_(t)
        return x
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if spec["kind"] == "attn":
        kw = _attn_kwargs(cfg, spec)
        # the ring's slots: this device's rows times the cache's shards
        rolling = c["k"].shape[1] * hints.kv_shards() \
            if perf.get().windowed_local_cache and kw["window"] > 0 else 0
        y, _, _ = attn_mod.attention_decode(
            bp["attn"], h, c["k"], c["v"], pos, rolling_window=rolling,
            impl=impl, **kw)
        if cfg.post_norm:
            y = rmsnorm(bp["ln1p"], y, cfg.norm_eps)
        x = x + y
        return x + _apply_ffn_part(cfg, spec, bp, x)[0]
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
    params = _top(params)
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
