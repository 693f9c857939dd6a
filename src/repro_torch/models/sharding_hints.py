"""Sharding anchors and the token layout under a device mesh (port of
``repro.models.sharding_hints``).

The global scheme is ``repro``'s: activations shard **by tokens** (batch
over ('pod', 'data'), sequence over 'model'), and weights are stored
sharded over both axes and all-gathered on use (ZeRO-3).

``repro`` leaves the rest to GSPMD.  Here the parts split:

* ``ambient_mesh``, ``constrain``, ``constrain_tokens``, ``BATCH`` and
  ``placements``: ``repro``'s anchors on DTensors.  Where a mesh is set
  (``use_mesh``, entered by ``launch.mesh.set_mesh``) and x is a DTensor,
  ``constrain`` redistributes it to the spec's placements; otherwise it
  returns x itself.  The sharded steps (``launch.steps``) anchor their
  inputs and outputs with them.
* ``local_tokens``: inside a sharded step the model runs on each device's
  own tokens as plain tensors (the steps enter it through ``local_map``),
  and this layout says which mesh axes shard the batch, the sequence and
  the KV caches' rows.  The model reads it where ``repro`` places its
  anchors: ``gather_params`` where a weight is used (its all-gather, whose
  gradient is reduce-scattered back to the shards), ``seq_offset`` and
  ``gather_seq`` in attention (``repro``'s query-block sharding against
  gathered K/V, ``models/attention.py:151-155``) and around the recurrent
  mixers (which need the whole sequence), ``kv_offset``/``combine_kv`` in
  decode over a cache sharded along S, and ``token_sum`` where a mean runs
  over every token (the loss, the MoE balance loss).  Without a layout
  each of these returns its input, so the unsharded paths run exactly as
  before.  Mesh axes of size 1 are left out of the layout: they move
  nothing.

Specs are tuples, one entry per tensor dim: None, an axis name, or a tuple
of axis names (split over several mesh axes, the first outermost).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

BATCH = ("pod", "data")   # canonical batch sharding axes (filtered to mesh)

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)
_TOKENS: contextvars.ContextVar = contextvars.ContextVar("tokens",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def ambient_mesh():
    """The ambient mesh, or None."""
    return _MESH.get()


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(ax) -> tuple:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def _size(sizes: dict, axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= sizes.get(a, 1)
    return n


@functools.lru_cache(maxsize=4096)
def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a tensor dim split over
    axes ``(a, b)`` is ``Shard(dim)`` on both mesh dims (a outermost, as in
    JAX; the axes must follow the mesh's order); unnamed mesh dims
    replicate."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        axs = _axes(ax)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axs} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _fit(mesh, spec_axes: tuple, shape) -> tuple:
    """``repro``'s filter: axes not in the mesh, or whose sizes do not
    divide their dim, drop out."""
    sizes = axis_sizes(mesh)
    spec = []
    for dim, ax in enumerate(spec_axes):
        axs = tuple(a for a in _axes(ax) if a in sizes)
        if not axs or shape[dim] % _size(sizes, axs) != 0:
            spec.append(None)
        else:
            spec.append(axs if len(axs) > 1 else axs[0])
    return tuple(spec)


def constrain(x, spec_axes: tuple):
    """Generic anchor: x redistributed to ``spec_axes`` (axes not in the
    mesh or not dividing their dim dropped) when a mesh is set and x is a
    DTensor; x itself otherwise."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    pl = placements(mesh, _fit(mesh, spec_axes, x.shape))
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


def token_spec(mesh, shape, seq_axis: int = 1) -> tuple:
    """``constrain_tokens``' rule: the batch over the batch axes and the
    sequence over 'model', each where it divides (the sequence also needs
    at least one token per shard)."""
    sizes = axis_sizes(mesh)
    ba = tuple(a for a in BATCH if a in sizes)
    spec = [None] * len(shape)
    if ba and shape[0] % _size(sizes, ba) == 0:
        spec[0] = ba if len(ba) > 1 else ba[0]
    m = sizes.get("model")
    if m and len(shape) > seq_axis and shape[seq_axis] % m == 0 \
            and shape[seq_axis] >= m:
        spec[seq_axis] = "model"
    return tuple(spec)


def constrain_tokens(x, seq_axis: int = 1):
    """x: (B, T, ...) -> P(batch_axes, 'model', None...) where divisible."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return constrain(x, token_spec(mesh, x.shape, seq_axis))


def kv_cache_axes(sizes: dict, batch_size: int) -> tuple[tuple, tuple]:
    """(axes of a KV cache's batch dim, axes of its S dim), ``repro``'s
    rule: the batch over the batch axes when it divides (and has a row per
    shard), S over 'model'; otherwise (long_500k at B 1) S over the batch
    axes and 'model' (sequence parallelism)."""
    ba = tuple(a for a in BATCH if a in sizes)
    n = _size(sizes, ba)
    if batch_size % n == 0 and batch_size >= n:
        return ba, ("model",)
    return (), ba + ("model",)


# ------------------------------------------------------------ local tokens --
class Tokens(NamedTuple):
    """Where a sharded step's local tensors sit: the mesh axes (of size > 1)
    that shard the batch, the sequence and the KV caches' rows."""
    mesh: object
    batch: tuple
    seq: tuple
    kv: tuple


def tokens_of(mesh, batch_spec_axes, seq_spec_axes, kv_axes) -> Tokens:
    """The layout of a step whose tokens follow those specs (size-1 axes
    dropped)."""
    sizes = axis_sizes(mesh)
    keep = lambda axs: tuple(a for a in _axes(axs) if sizes[a] > 1)
    return Tokens(mesh, keep(batch_spec_axes), keep(seq_spec_axes),
                  keep(kv_axes))


@contextlib.contextmanager
def local_tokens(lay: Tokens):
    """The model inside the block runs on local tokens laid out so."""
    tok = _TOKENS.set(lay)
    try:
        yield lay
    finally:
        _TOKENS.reset(tok)


def layout() -> Tokens | None:
    return _TOKENS.get()


def _index(mesh, axes) -> int:
    """This device's row-major index over ``axes`` (the first outermost)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return idx


def _gather(x, axes, dim: int):
    """x's pieces on the devices along ``axes`` concatenated along ``dim``
    in their order; the gradient is summed back to each piece."""
    lay = layout()
    sub = lay.mesh[axes] if len(axes) > 1 else lay.mesh[axes[0]]
    n = len(axes)
    pl = [Shard(dim)] * n
    d = DTensor.from_local(x, sub, pl, run_check=False)
    for i in reversed(range(n)):     # one all-gather a mesh axis, inner first
        pl[i] = Replicate()
        d = d.redistribute(sub, pl)
    return d.to_local(grad_placements=[Partial()] * n)


def seq_offset(t_local: int) -> int:
    """The position of this device's first token (0 unsharded)."""
    lay = layout()
    if lay is None or not lay.seq:
        return 0
    return _index(lay.mesh, lay.seq) * t_local


def gather_seq(x, dim: int = 1):
    """The whole sequence from each device's rows (x itself unsharded)."""
    lay = layout()
    if lay is None or not lay.seq:
        return x
    return _gather(x, lay.seq, dim)


def local_rows(x, dim: int = 1):
    """This device's rows of a whole-sequence tensor (x itself unsharded)."""
    lay = layout()
    if lay is None or not lay.seq:
        return x
    t = x.shape[dim] // seq_shards()
    return x.narrow(dim, _index(lay.mesh, lay.seq) * t, t)


def _shards(field: str) -> int:
    """Devices along the layout's ``field`` axes (1 without a layout)."""
    lay = layout()
    n = 1
    for a in (() if lay is None else getattr(lay, field)):
        n *= lay.mesh.size(lay.mesh.mesh_dim_names.index(a))
    return n


def seq_shards() -> int:
    return _shards("seq")


def batch_shards() -> int:
    return _shards("batch")


def kv_shards() -> int:
    return _shards("kv")


def token_shards() -> int:
    """Devices holding different tokens (batch shards x sequence shards)."""
    return batch_shards() * seq_shards()


def last_row(x):
    """x[:, -1:] of the whole sequence: the last device's last row."""
    lay = layout()
    if lay is None or not lay.seq:
        return x[:, -1:]
    return _gather(x[:, -1:], lay.seq, 1)[:, -1:]


def token_sum(x):
    """x summed over every device that holds other tokens (no gradient:
    callers weight their own tokens' terms by it)."""
    lay = layout()
    axes = () if lay is None else lay.batch + lay.seq
    if not axes:
        return x
    with torch.no_grad():
        sub = lay.mesh[axes] if len(axes) > 1 else lay.mesh[axes[0]]
        pl = [Partial()] * len(axes)
        d = DTensor.from_local(x, sub, pl, run_check=False)
        for i in range(len(axes)):     # one all-reduce a mesh axis
            pl[i] = Replicate()
            d = d.redistribute(sub, pl)
        return d.to_local()


def kv_offset(rows: int) -> int:
    """The cache row (slot) of this device's first KV row (0 unsharded)."""
    lay = layout()
    if lay is None or not lay.kv:
        return 0
    return _index(lay.mesh, lay.kv) * rows


def combine_kv(out, lse, combine):
    """Decode attention over a cache sharded along S: every shard's output
    and log-sum-exp gathered in shard order and merged by ``combine``."""
    lay = layout()
    outs = _gather(out[None], lay.kv, 0)
    lses = _gather(lse[None], lay.kv, 0)
    return combine(outs, lses)


def gather_param(a, g: int | None = None):
    """A weight for use: group g of a stacked leaf (the whole leaf for g
    None), all-gathered where it is a DTensor.  Its gradient comes back to
    the shards summed over the devices holding other tokens (Partial on
    those mesh axes), as ZeRO-3 reduce-scatters it."""
    if not isinstance(a, DTensor):
        return a if g is None else a[g]
    mesh, pl = a.device_mesh, list(a.placements)
    lay = layout()
    tok = () if lay is None else lay.batch + lay.seq
    if (not tok or not torch.is_grad_enabled()) and all(
            mesh.size(i) == 1 for i, p in enumerate(pl) if p.is_shard()):
        # nothing to gather, and the gradient (if any) is the piece's own
        loc = a.to_local()
        return loc if g is None else loc[g]
    if g is not None:
        # the group axis is never sharded (specs right-align to the weight)
        pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl]
        a = DTensor.from_local(a.to_local()[g], mesh, pl, run_check=False)
    # the local gradient is whole: Partial over the token axes; on a mesh
    # axis of size 1 the weight's own placement says the same
    grad_pl = [Partial() if name in tok else
               (p if mesh.size(i) == 1 else Replicate())
               for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, pl))]
    if all(mesh.size(i) == 1 for i, p in enumerate(pl) if p.is_shard()):
        return a.to_local(grad_placements=grad_pl)
    return a.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad_pl)


def gather_params(tree, g: int | None = None):
    """``gather_param`` over a nested dict of weights."""
    if isinstance(tree, dict):
        return {k: gather_params(v, g) for k, v in tree.items()}
    return gather_param(tree, g)
