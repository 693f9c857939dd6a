"""Named-axis sharding rules for params, batches and decode caches (port of
``repro.launch.sharding``), and their placement on a device mesh.

Strategy (``repro``'s):
  * 'model' (TP): attention head dims, FFN hidden dim, MoE d_ff, vocab dim.
  * 'data' (FSDP+EP): the non-TP dim of every large 2-D weight, the MoE
    expert axis, and the batch.  Optimizer states inherit these specs
    (``optim.state_pspec``), so parameter and state memory scale as
    1/(data*model).
  * 'pod': pure data parallelism across pods (params replicated across
    pods).

KV caches: the batch shards over 'data' when divisible, otherwise
(long_500k, batch 1) the *sequence* axis shards over 'data' (sequence
parallelism); the sequence axis additionally shards over 'model'.

A spec is a tuple with one entry per tensor dim (``repro``'s
``PartitionSpec``): None, an axis name, or a tuple of axis names; ``()``
replicates.  Functions here take the mesh's axis sizes (a dict, see
``axis_sizes``), so the rules run without a process group;
``sharding_hints.placements`` turns a spec into DTensor placements on a
mesh, and ``distribute`` places a tree by a tree of specs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import distribute_tensor

from ..models.sharding_hints import axis_sizes, kv_cache_axes, placements

__all__ = ["PROD_AXIS_SIZES", "NamedSharding", "axis_sizes", "batch_pspec",
           "cache_entry_pspec", "distribute", "make_cache_pspecs",
           "make_param_pspecs", "map_specs", "param_pspec", "placements",
           "shardings"]

# path keys
_COLUMN_PARALLEL = {"wq", "wk", "wv", "wi", "wg", "ck", "cr", "in_proj",
                    "shared_ffn"}
_ROW_PARALLEL = {"wo", "cv", "out_proj"}

PROD_AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _filter_spec(spec: tuple, shape: tuple, sizes: dict) -> tuple:
    """Drop sharded axes that do not divide their dim (e.g. vocab 49155)."""
    out = []
    for dim, ax in enumerate(spec):
        if ax is None or dim >= len(shape):
            out.append(None)
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes.get(a, 1)
        out.append(ax if shape[dim] % n == 0 else None)
    return tuple(out)


def param_pspec(names: list, shape: tuple,
                sizes: dict = PROD_AXIS_SIZES) -> tuple:
    """The spec of one parameter leaf, keyed on its path of dict keys.

    Stacked (per-group) params carry a leading group axis, so specs are
    right-aligned to the trailing (true weight) dims.  Axes that do not
    divide a dim are dropped (granite's 49155 vocab, mixtral's 8 experts).
    """
    ndim = len(shape)

    def align(*spec):
        pad = (None,) * (ndim - len(spec))
        return _filter_spec(pad + spec, shape, sizes)

    if "embed" in names:                       # (V, d): V-FSDP, d-TP
        return align("data", "model")
    if "head" in names:                        # (d, V): d-FSDP, V-TP
        return align("data", "model")

    # MoE stacks: (G, E, d, f) / (G, E, f, d) / router (G, d, E)
    if "moe" in names:
        e_dim = shape[-3] if ndim >= 3 else 0
        ep_ok = e_dim % sizes.get("data", 1) == 0
        if names[-1] in ("wi", "wg"):
            return align("data", None, "model") if ep_ok else \
                align(None, "data", "model")
        if names[-1] == "wo":
            return align("data", "model", None) if ep_ok else \
                align(None, "model", "data")
        if names[-1] == "router":
            return align(None, None)

    for nm in names:
        if nm in _COLUMN_PARALLEL and ndim >= 2:
            return align("data", "model")
        if nm in _ROW_PARALLEL and ndim >= 2:
            return align("model", "data")

    # rwkv decay lora / conv weights: shard the d_model-sized axis
    if names[-1] == "wA":
        return align("data", None)
    if names[-1] == "wB":
        return align(None, "data")
    if names[-1] == "conv_w":
        return align(None, "model")

    return ()   # norms, biases, scalars: replicated


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(list(path), tree)


def make_param_pspecs(params, sizes: dict = PROD_AXIS_SIZES):
    """The spec tree of a param tree (tensors, or anything with a shape)."""
    return _map_with_path(
        lambda names, leaf: param_pspec(names, tuple(leaf.shape), sizes),
        params)


def _entry(axes: tuple):
    """A spec entry for a tensor dim over ``axes``: one axis by its name
    (as ``PartitionSpec`` normalises it), several as a tuple."""
    return axes[0] if len(axes) == 1 else axes


# ------------------------------ batches --------------------------------------
def batch_axes_of(sizes: dict) -> tuple:
    return ("pod", "data") if "pod" in sizes else ("data",)


def batch_pspec(sizes: dict, batch: dict) -> dict:
    """Shard every batch leaf along its leading (batch) axis."""
    ba = _entry(batch_axes_of(sizes))
    return {k: (ba,) + (None,) * (len(v.shape) - 1) for k, v in batch.items()}


# ------------------------------- caches --------------------------------------
def cache_entry_pspec(sizes: dict, names: list, shape: tuple,
                      batch_size: int) -> tuple:
    """KV ('k'/'v'): (G, B, S, Kh, dh); recurrent states: (G, B, ...)."""
    ndim = len(shape)
    b_axes, s_axes = kv_cache_axes(sizes, batch_size)
    if names[-1] in ("k", "v"):
        if b_axes:
            return (None, _entry(b_axes), "model", None, None)
        return (None, None, s_axes, None, None)    # sequence parallelism
    if ndim >= 2 and b_axes:
        return (None, _entry(b_axes)) + (None,) * (ndim - 2)
    return (None,) * ndim


def make_cache_pspecs(sizes: dict, cache, batch_size: int):
    return _map_with_path(
        lambda names, leaf: cache_entry_pspec(sizes, names, tuple(leaf.shape),
                                              batch_size), cache)


# ------------------------------ placement ------------------------------------
@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def map_specs(fn, tree, specs):
    """fn(leaf, spec) over a tree of dicts and NamedTuples and its spec tree
    (the same nodes, a spec tuple at each leaf), rebuilt as ``tree``."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, s) for v, s in zip(tree, specs)))
    return fn(tree, specs)


def distribute(tree, mesh, specs):
    """Each tensor leaf of ``tree`` as a DTensor placed by its spec (every
    device holds the whole leaf and keeps its own piece)."""
    def place(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, placements(mesh, spec),
                                 src_data_rank=None)
    return map_specs(place, tree, specs)


def shardings(mesh, specs):
    """The tree of ``NamedSharding``s of a spec tree (for
    ``checkpoint.restore``)."""
    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(*(walk(v) for v in s))
        return NamedSharding(mesh, s)
    return walk(specs)
