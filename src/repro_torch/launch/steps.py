"""Step functions (port of ``repro.launch.steps``): train, prefill, decode.

Unsharded, ``make_train_step(cfg)`` returns ``{"fn", "opt", "make_init"}``:
``fn(state, batch) -> (state, {"loss", "step"})`` differentiates
``lm.loss_fn`` with autograd and applies the optimizer in place; the train
state is the dict ``{"params", "opt", "step"}``, as in ``repro``, so
checkpoints carry the same leaves.  ``impl`` and ``dtype`` pass through to
the model, as in ``lm.prefill``.

Sharded (given a device mesh), every step places its inputs by
``repro``'s specs as DTensors (``launch.sharding``) and runs the model on
each device's own tokens (``sharding_hints.local_tokens``; ``local_map`` for
serving): ``make_train_step(cfg, mesh=mesh)`` places the state by
``state_spec`` and the batch by ``batch_spec_of``, and the optimizer updates
the DTensor shards; ``make_prefill(cfg, mesh, max_seq)`` and
``make_decode_step(cfg, mesh, max_seq, batch_size)`` return logits and the
cache with ``repro``'s output specs (the vocabulary over 'model' where it
divides), and decode updates the cache in place.  Params keep their
training specs for serving too unless ``perf.tp_serving_params`` is on
(``repro``'s C3, off by default: stripping the 'data' axis raised each
device's weight reads 16x there); ``make_decode_step`` reads the flag when
it is made, as ``repro``'s does, and its ``param_spec`` then keeps only the
'model' sharding (``_strip_data_axis``).  Each returns a dict with
``repro``'s keys where they apply (no ``jit``: PyTorch runs eagerly);
``input_specs``, ``param_specs`` and ``cache_specs`` give meta tensors,
shapes without memory, for the dry run (the caches' rows follow
``perf.windowed_local_cache`` at the time of the call).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import (
    implicit_replication,
    local_map,
)

from .. import perf
from ..models import lm
from ..models import sharding_hints as hints
from ..models.config import ModelConfig
from ..models.convert import resolve_device
from ..optim import make_optimizer, state_pspec
from ..pytree import flatten, unflatten
from .mesh import set_mesh
from .sharding import (
    axis_sizes,
    batch_axes_of,
    batch_pspec,
    distribute,
    make_cache_pspecs,
    make_param_pspecs,
    map_specs,
    placements,
)


# ------------------------------ input specs ----------------------------------
def input_specs(cfg: ModelConfig, shape, kind: str | None = None) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    kind = kind or shape.kind
    b, t = shape.global_batch, shape.seq_len
    meta = lambda *s, dtype: torch.empty(s, dtype=dtype, device="meta")
    i32, bf16 = torch.int32, torch.bfloat16
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(kind)
    batch = {}
    if kind == "train":
        batch["labels"] = meta(b, t, dtype=i32)
    if kind == "decode":
        batch["pos"] = meta(b, dtype=i32)
        t = 1
    if cfg.input_mode == "embeds":
        batch["embeds"] = meta(b, t, cfg.d_model, dtype=bf16)
    else:
        batch["token" if kind == "decode" else "tokens"] = meta(b, t,
                                                               dtype=i32)
    return batch


def param_specs(cfg: ModelConfig):
    """The param tree as meta tensors (drawn under a fake mode: nothing is
    allocated)."""
    with FakeTensorMode():
        params = lm.init_params(cfg, torch.Generator(), device="cpu")
    return _to_meta(params)


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def cache_specs(cfg: ModelConfig, batch_size: int, max_seq: int):
    return lm.init_cache(cfg, batch_size, max_seq, device="meta")


# ------------------------------ placement ------------------------------------
def _flat_specs(tree, specs) -> list:
    """The specs of ``tree``'s leaves in ``pytree.flatten``'s order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _flat_specs(tree[k],
                                                             specs[k])]
    if isinstance(tree, (tuple, list)):
        return [s for v, sp in zip(tree, specs) for s in _flat_specs(v, sp)]
    return [specs]


def _place(x, mesh, spec):
    """x as a DTensor placed by ``spec``: redistributed if it is one, else
    every device's copy cut to its piece."""
    pl = placements(mesh, spec)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    return distribute(x, mesh, spec)


def batch_spec(sizes: dict, batch, batch_size: int | None = None) -> dict:
    """``sharding.batch_pspec``, with a leaf replicated where its batch
    does not divide the batch axes (or, given ``batch_size``, is another
    size), as ``repro``'s decode step does."""
    n = 1
    for a in batch_axes_of(sizes):
        n *= sizes[a]
    return {k: s if (batch_size is None or batch[k].shape[0] == batch_size)
            and batch[k].shape[0] % n == 0 else (None,) * len(s)
            for k, s in batch_pspec(sizes, batch).items()}


def _layout(mesh, b: int, t: int, kv: bool):
    """The token layout of a step over a (b, t) batch (``constrain_tokens``'
    rule) with, for serving, the KV caches' row axes."""
    sizes = axis_sizes(mesh)
    spec = hints.token_spec(mesh, (b, t))
    kv_axes = hints.kv_cache_axes(sizes, b)[1] if kv else ()
    return hints.tokens_of(mesh, spec[0], spec[1], kv_axes)


def _logits_spec(cfg, sizes: dict, batch_ok: bool, vocab: bool) -> tuple:
    ba = batch_axes_of(sizes)
    ba = ba[0] if len(ba) == 1 else ba
    vocab_ax = "model" if vocab and cfg.vocab % sizes["model"] == 0 else None
    return (ba if batch_ok else None, None, vocab_ax)


def _run_local(mesh, layout, fn, args, arg_specs, out_like, out_specs):
    """fn(*local args) on every device through ``local_map``: each DTensor
    of ``args`` (placed by ``arg_specs``) as its local piece, the outputs
    (structured as ``out_like``) wrapped by ``out_specs``."""
    in_leaves, in_def = flatten(args)
    in_pl = tuple(placements(mesh, s) for s in _flat_specs(args, arg_specs))
    _, out_def = flatten(out_like)
    out_pl = tuple(placements(mesh, s)
                   for s in _flat_specs(out_like, out_specs))

    def body(*local):
        with hints.local_tokens(layout):
            out = fn(*unflatten(in_def, local))
        leaves, d = flatten(out)
        if d != out_def:
            raise ValueError(f"step output {d} is not {out_def}")
        return tuple(leaves)

    outs = local_map(body, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh)(*in_leaves)
    return unflatten(out_def, outs)


# ------------------------------ train step -----------------------------------
def make_train_step(cfg: ModelConfig, optimizer_name: str = "adamw",
                    lr=3e-4, *, mesh=None, impl: str = "auto",
                    dtype=lm.COMPUTE_DTYPE, device="cuda") -> dict:
    """The train step; sharded over ``mesh`` when one is given (then also
    ``state_spec`` and ``batch_spec_of``, and ``make_init`` places the
    state)."""
    dev = resolve_device(device)
    opt = make_optimizer(optimizer_name, lr)

    def grads_of(params, batch):
        leaves, treedef = flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = lm.loss_fn(cfg, params, batch, impl=impl, dtype=dtype)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss, unflatten(treedef, [torch.zeros_like(p) if g is None
                                         else g for p, g in zip(leaves,
                                                                grads)])

    def train_step(state, batch):
        params = state["params"]
        loss, grads = grads_of(params, batch)
        new_params, new_opt = opt.update(grads, state["opt"], params)
        step = state["step"] + 1
        return ({"params": new_params, "opt": new_opt, "step": step},
                {"loss": loss.detach(), "step": step})

    def make_init(seed: int = 0):
        def init():
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = lm.init_params(cfg, gen, device=dev)
            return {"params": params, "opt": opt.init(params),
                    "step": torch.zeros((), dtype=torch.int32, device=dev)}
        return init

    if mesh is None:
        return {"fn": train_step, "opt": opt, "make_init": make_init}

    sizes = axis_sizes(mesh)
    p_structs = param_specs(cfg)
    p_spec = make_param_pspecs(p_structs, sizes)
    state_spec = {"params": p_spec,
                  "opt": state_pspec(opt.name, p_spec, p_structs),
                  "step": ()}

    def batch_spec_of(batch_struct) -> dict:
        return batch_spec(sizes, batch_struct)

    def sharded_step(state, batch):
        spec = batch_spec_of(batch)
        b, t = batch["labels"].shape
        layout = _layout(mesh, b, t, kv=False)
        with set_mesh(mesh):
            batch = {k: _place(v, mesh, spec[k]).to_local()
                     for k, v in batch.items()}
            params = state["params"]
            with hints.local_tokens(layout):
                loss, grads = grads_of(params, batch)
            with implicit_replication():
                new_params, new_opt = opt.update(grads, state["opt"], params)
                step = state["step"] + 1
            # each device's loss is its share of the global mean
            tok = layout.batch + layout.seq
            loss = DTensor.from_local(
                loss.detach(), mesh,
                [Partial() if a in tok else Replicate()
                 for a in mesh.mesh_dim_names], run_check=False)
            loss = loss.full_tensor()
        return ({"params": new_params, "opt": new_opt, "step": step},
                {"loss": loss, "step": step})

    def make_sharded_init(seed: int = 0):
        def init():
            return distribute(make_init(seed)(), mesh, state_spec)
        return init

    return {"fn": sharded_step, "opt": opt, "state_spec": state_spec,
            "batch_spec_of": batch_spec_of, "make_init": make_sharded_init}


# ------------------------------ serve steps ----------------------------------
def make_prefill(cfg: ModelConfig, mesh, max_seq: int, *, impl: str = "auto",
                 dtype=lm.COMPUTE_DTYPE) -> dict:
    """``fn(params, batch) -> (logits (B, 1, V), cache)``, sharded; params
    placed by ``param_spec`` (``launch.sharding.distribute``)."""
    sizes = axis_sizes(mesh)
    p_spec = make_param_pspecs(param_specs(cfg), sizes)

    def prefill_fn(params, batch):
        spec = batch_spec(sizes, batch)
        x = next(iter(batch.values()))
        b, t = x.shape[0], x.shape[1]
        c_struct = cache_specs(cfg, b, max_seq)
        c_spec = make_cache_pspecs(sizes, c_struct, b)
        layout = _layout(mesh, b, t, kv=True)
        batch_ok = spec[next(iter(spec))][0] is not None
        with set_mesh(mesh):
            batch = {k: _place(v, mesh, spec[k]) for k, v in batch.items()}
            logits, cache = _run_local(
                mesh, layout,
                lambda bt: lm.prefill(cfg, params, bt, max_seq, impl=impl,
                                      dtype=dtype),
                (batch,), (spec,), (x, c_struct),
                (_logits_spec(cfg, sizes, batch_ok, False), c_spec))
            logits = hints.constrain(logits, _logits_spec(cfg, sizes,
                                                          batch_ok, True))
        return logits, cache

    return {"fn": prefill_fn, "param_spec": p_spec}


def _strip_data_axis(spec: tuple) -> tuple:
    """C3 (§Perf): serving params keep only the TP ('model') sharding."""
    return tuple(None if a == "data" or (isinstance(a, tuple) and "data" in a)
                 else a for a in spec)


def make_decode_step(cfg: ModelConfig, mesh, max_seq: int, batch_size: int,
                     *, impl: str = "auto", dtype=lm.COMPUTE_DTYPE) -> dict:
    """``fn(params, cache, batch) -> (logits (B, 1, V), cache)``, sharded;
    the cache (placed by ``cache_spec``) is updated in place.  Params are
    placed by ``param_spec``: their training specs, or with
    ``perf.tp_serving_params`` on when the step is made, those specs with
    the 'data' axis stripped."""
    sizes = axis_sizes(mesh)
    p_spec = make_param_pspecs(param_specs(cfg), sizes)
    if perf.get().tp_serving_params:
        p_spec = map_specs(lambda _, sp: _strip_data_axis(sp), p_spec,
                           p_spec)
    c_struct = cache_specs(cfg, batch_size, max_seq)
    c_spec = make_cache_pspecs(sizes, c_struct, batch_size)
    layout = _layout(mesh, batch_size, 1, kv=True)

    def decode_fn(params, cache, batch):
        spec = batch_spec(sizes, batch, batch_size)
        batch_ok = spec["pos"][0] is not None
        with set_mesh(mesh):
            batch = {k: _place(v, mesh, spec[k]) for k, v in batch.items()}
            cache = {k: {n: _place(v, mesh, c_spec[k][n])
                         for n, v in c.items()} for k, c in cache.items()}
            logits, cache = _run_local(
                mesh, layout,
                lambda c, bt: lm.decode_step(cfg, params, bt, c, impl=impl,
                                             dtype=dtype),
                (cache, batch), (c_spec, spec),
                (batch["pos"], c_struct),
                (_logits_spec(cfg, sizes, batch_ok, False), c_spec))
            logits = hints.constrain(logits, _logits_spec(cfg, sizes,
                                                          batch_ok, True))
        return logits, cache

    return {"fn": decode_fn, "param_spec": p_spec, "cache_spec": c_spec,
            "cache_struct": c_struct}


__all__ = ["batch_spec", "cache_specs", "input_specs", "make_decode_step",
           "make_prefill", "make_train_step", "param_specs"]
