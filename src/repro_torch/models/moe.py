"""Mixture-of-Experts FFN with capacity-bounded einsum dispatch (port of
``repro.models.moe``).

GShard-style: top-k routing -> one-hot dispatch/combine tensors -> batched
SwiGLU expert FFNs, weights stacked on a leading expert axis.  Top-1
(llama4, with an always-on shared expert added by the caller) and top-2
(mixtral).  ``repro`` computes every product here as an ``einsum`` outside
any Pallas kernel, so they stay ``torch.einsum``.

Numerics follow ``repro``: the router and its softmax in fp32, the
combine tensor in the activation dtype under ``perf.bf16_moe_dispatch``
(the default) and in fp32 without it (the baseline), the routing positions
in fp32, SiLU in fp32.  Three places where torch differs from JAX are
written out:

* top-k: ``lax.top_k`` puts the lowest index first among equal values;
  ``torch.topk`` promises no order, so a stable descending sort is used.
* one-hot of a capacity slot: ``jax.nn.one_hot`` gives a zero row for an
  index at or past the capacity (a dropped token), where
  ``F.one_hot`` raises; an index compare gives the zero row.
* the capacity ``int(capacity_factor * top_k * t / e)`` stays Python.

``moe_ffn`` without a mesh takes the flat path, as ``repro``'s does without
a 'model' mesh axis (``perf.grouped_moe_dispatch`` then changes nothing);
``_moe_grouped`` (GShard groups of tokens) is reached through an explicit
group count.  Under a sharded step the model sees each device's own tokens
(the sequence over 'model' where it divides), and ``repro`` groups them by
'model' shard (routing capacity per shard) under
``perf.grouped_moe_dispatch`` when the sequence has at least two tokens a
shard: the flat path on the local tokens is that group.  With one token a
shard, or without the flag, ``repro`` routes each row's whole sequence
with one capacity, so the sequence is gathered first, routed flat, and
each device keeps its own rows.  The balance loss is each device's share
of the global one (``_aux``).
``layers.with_compute_copies`` adds a copy of the stacked expert weights in
the compute dtype (``"wi_c"``, ``"wg_c"``, ``"wo_c"``), the same values as
``repro``'s per-call cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import perf
from . import sharding_hints as hints
from .layers import normal


def moe_init(gen, n_experts: int, d: int, d_ff: int, *, device="cpu"):
    s_in, s_out = d ** -0.5, d_ff ** -0.5
    return {
        "wi": normal(gen, (n_experts, d, d_ff), s_in, device),
        "wg": normal(gen, (n_experts, d, d_ff), s_in, device),
        "wo": normal(gen, (n_experts, d_ff, d), s_out, device),
        "router": normal(gen, (d, n_experts), s_in, device),
    }


def expert_weight(params, name: str, dtype) -> torch.Tensor:
    """The stacked expert weight ``name`` in ``dtype`` (the held copy when
    there is one; copies are for serving only, and training refuses them:
    a gradient would land on the copy, not the fp32 master)."""
    wc = params.get(name + "_c")
    return wc if wc is not None and wc.dtype == dtype else \
        params[name].to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lowest
    index first among equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params, x, *, top_k: int, capacity_factor: float = 1.25,
            groups: int = 1):
    """x: (B, T, d) -> ((B, T, d), aux load-balancing loss).

    ``groups`` > 1 splits T into that many token groups, each with its own
    capacity (``repro``'s grouping by 'model' shards).  Under a sharded step
    x is already one device's group, so the default of 1 serves both.
    """
    b, t, d = x.shape
    if hints.seq_shards() > 1 and (t < 2 or
                                   not perf.get().grouped_moe_dispatch):
        # repro routes each row's whole sequence as one group; every
        # sequence shard computes it, and _aux gives each 1/shards of it
        y, aux = _moe_flat(params, hints.gather_seq(x), top_k=top_k,
                           capacity_factor=capacity_factor)
        return hints.local_rows(y), aux
    if groups > 1:
        y, aux = _moe_grouped(params, x.reshape(b, groups, t // groups, d),
                              top_k=top_k, capacity_factor=capacity_factor)
        return y.reshape(b, t, d), aux
    return _moe_flat(params, x, top_k=top_k, capacity_factor=capacity_factor)


def _route(params, x, k: int, capacity_factor: float, tokens_axis: int):
    """Router probabilities, renormalised top-k gates, and the combine
    tensor (..., T, E, C) in the activation dtype, for tokens along
    ``tokens_axis`` (the capacity is counted over that axis)."""
    e = params["router"].shape[-1]
    t = x.shape[tokens_axis]
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    capacity = max(1, int(capacity_factor * k * t / e))
    comb_dt = x.dtype if perf.get().bf16_moe_dispatch else torch.float32
    slots = torch.arange(capacity, device=x.device)

    # position of each (token, choice) within its expert's buffer; later
    # choices are offset by all earlier choices' per-expert counts, so
    # buffer slots never collide across the k rounds (GShard)
    combine = torch.zeros((*x.shape[:-1], e, capacity), dtype=comb_dt,
                          device=x.device)
    base_shape = list(x.shape[:-1]) + [e]
    base_shape[tokens_axis] = 1
    base = torch.zeros(base_shape, device=x.device)
    for j in range(k):
        sel = F.one_hot(gate_idx[..., j], e).float()           # (.., T, E)
        pos_in_e = (torch.cumsum(sel, dim=tokens_axis) - 1.0 + base) * sel
        keep = pos_in_e < capacity                             # drop overflow
        # one-hot over the capacity: a zero row at or past it
        pos_oh = (pos_in_e.long()[..., None] == slots).to(comb_dt)
        pos_oh = pos_oh * (sel * keep).to(comb_dt)[..., None]
        combine = combine + gate_vals[..., j, None, None].to(comb_dt) * pos_oh
        base = base + sel.sum(dim=tokens_axis, keepdim=True)
    return probs, gate_idx, combine


def _experts(params, xe, dtype):
    """Batched SwiGLU experts on the capacity buffers (.., E, C, d)."""
    h = torch.einsum("...ecd,edf->...ecf", xe,
                     expert_weight(params, "wi", dtype))
    g = torch.einsum("...ecd,edf->...ecf", xe,
                     expert_weight(params, "wg", dtype))
    h = F.silu(g.float()).to(dtype) * h
    return torch.einsum("...ecf,efd->...ecd", h,
                        expert_weight(params, "wo", dtype))


def _aux(probs, gate_idx, e: int, dims) -> torch.Tensor:
    """Switch-style load-balance loss: e * sum(mean prob * top-1 share).

    Under a sharded step the means run over every device's tokens: the
    top-1 shares are summed over the devices, and this device returns its
    tokens' part of the mean probability times them, so the parts sum to
    the loss and each part's gradient is its own tokens'.  Routed over the
    gathered sequence, every sequence shard holds the same tokens: n and
    the summed shares count each of them once per shard, so each shard's
    part is 1/shards of its rows' and the parts still sum to the loss."""
    shards = hints.token_shards()
    if shards == 1:
        me = probs.mean(dim=dims)
        ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=dims)
        return e * torch.sum(me * ce)
    n = probs[..., 0].numel() * shards
    ce = hints.token_sum(F.one_hot(gate_idx[..., 0], e).float().sum(dim=dims))
    return e * torch.sum(probs.sum(dim=dims) / n * (ce / n))


def _moe_flat(params, x, *, top_k: int, capacity_factor: float):
    e = params["router"].shape[-1]
    probs, gate_idx, combine = _route(params, x, top_k, capacity_factor, 1)
    dispatch = (combine > 0).to(x.dtype)                       # (B, T, E, C)
    xe = torch.einsum("btec,btd->becd", dispatch, x)           # (B, E, C, d)
    ye = _experts(params, xe, x.dtype)
    y = torch.einsum("btec,becd->btd", combine.to(x.dtype), ye)
    return y, _aux(probs, gate_idx, e, (0, 1))


def _moe_grouped(params, x, *, top_k: int, capacity_factor: float):
    """x: (B, S, Tl, d), S token groups; routing capacity per group."""
    e = params["router"].shape[-1]
    probs, gate_idx, combine = _route(params, x, top_k, capacity_factor, 2)
    dispatch = (combine > 0).to(x.dtype)                  # (B, S, Tl, E, C)
    xe = torch.einsum("bstec,bstd->bsecd", dispatch, x)
    ye = _experts(params, xe, x.dtype)
    y = torch.einsum("bstec,bsecd->bstd", combine.to(x.dtype), ye)
    return y, _aux(probs, gate_idx, e, (0, 1, 2))
