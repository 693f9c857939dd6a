"""Per-device cost of a sharded step, counted from the ops it runs (the
counterpart of ``repro.launch.hlo_analysis``).

``repro`` parses the compiled, post-SPMD HLO of a step and walks its call
graph.  PyTorch runs eagerly and has no HLO: here ``GraphCounter``, a
dispatch mode, sees every op one device runs while the step is traced under
``FakeTensorMode`` (shapes only, nothing allocated) on a fake process group
(``launch.dryrun``).  A mode stacked above DTensor would see the global op
(a DTensor matmul on a 16x16 mesh counts the global 2·M·K·N), so for every
op on DTensors the mode steps aside (``NotImplemented``) and counts the
local ops and collectives DTensor then runs; DTensor's own shape
propagation, which runs the op once at global shapes, is not counted.
Python loops unroll, so every group of a stack is seen (``repro`` multiplies
``while`` bodies by their trip count; 12 groups count 12 times here too).
The per-token recurrences (``models.loops.scan``: RWKV-6's WKV without
``perf.rwkv_chunked``) are folded: one step is traced and its ops, forward
and backward, count T times (``GraphCounter.repeated``), as ``repro``
counts its ``lax.scan``; tracing 32768 steps a layer would take hours under
``FakeTensorMode``.  The folded count equals the unrolled one
(``fold_loops=False``) in FLOPs, bytes and ops for a forward; the peak of
live bytes adds what the T - 1 untraced steps would leave alive (their
tensors saved for the backward, their slices of the output), as XLA's
``memory_analysis()`` counts what ``lax.scan`` stacks.

Conventions (per device, local shard shapes; ``repro``'s):
  * FLOPs: ``mm``/``bmm``/``addmm``/``baddbmm`` = 2 * prod(result) *
    contracted dim; ``convolution`` = 2 * prod(result) * C_in / groups *
    prod(kernel window); every other op 1 per element of its results.
  * HBM bytes: operands + results of every op that is not a view or a
    factory.  There is no fusion in an eager step, so every intermediate
    counts: an upper bound on what a fused program moves.
  * Collective bytes: all-reduce 2x the result (ring reduce-scatter +
    all-gather); all-gather, all-to-all and broadcast the result;
    reduce-scatter the operand.
  * Live bytes: the result of a non-view op opens a count of its bytes on
    its storage; every alias of that storage the mode sees (views,
    ``detach``, ``alias``, in-place results) joins the count, and the bytes
    are free when the last of them dies.  A storage, not a tensor object,
    holds memory: ``torch.utils.checkpoint``'s recomputation keeps detached
    aliases of what it recomputes, which live on after the tensors the ops
    returned.  The peak over the step estimates its temporary memory.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..models import loops
from ..models.loops import base_bytes, storage_key

_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")
_FREE = {"wait_tensor", "detach", "alias", "lift_fresh"}


@dataclass
class GraphCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)   # op name -> bytes
    ops: int = 0
    peak_live_bytes: float = 0.0

    def __add__(self, o):
        c = dict(self.collectives)
        for k, v in o.collectives.items():
            c[k] = c.get(k, 0.0) + v
        return GraphCost(self.flops + o.flops, self.bytes + o.bytes,
                         self.collective_bytes + o.collective_bytes, c,
                         self.ops + o.ops,
                         max(self.peak_live_bytes, o.peak_live_bytes))

    def scale(self, k: float):
        return GraphCost(self.flops * k, self.bytes * k,
                         self.collective_bytes * k,
                         {n: v * k for n, v in self.collectives.items()},
                         int(self.ops * k), self.peak_live_bytes)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _dot_flops(name: str, args, out) -> float:
    """2 * prod(result) * the contracted dim of the product's operands."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out) -> float:
    w = args[1]                        # (C_out, C_in / groups, *window)
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


class GraphCounter(TorchDispatchMode):
    """Counts the ops one device runs inside the ``with`` block
    (``.cost``).  Enter it inside the ``FakeTensorMode`` of the trace."""

    def __init__(self, fold_loops: bool = True):
        super().__init__()
        self.cost = GraphCost()
        self._live = 0
        # storage key -> [bytes freed with it, aliases alive]
        self._counts: dict[int, list] = {}
        self._paused = 0
        self._real_prop = None
        self._fold = (loops.folding(self.repeated) if fold_loops
                      else contextlib.nullcontext())

    @contextlib.contextmanager
    def repeated(self, n: int):
        """The ops inside the block count n times.  The block yields
        ``resident(*kept, during_bytes=0)``: ``kept`` are the tensors each
        of the n steps leaves alive after it ends (its tensors saved for
        the backward, its slice of the stacked output), one per storage, so
        the n - 1 steps not traced hold as many bytes again each, from the
        block's end until the last alias of that storage dies;
        ``during_bytes`` are bytes the untraced steps hold only while the
        block runs (the carry of the step before the last).  The peak is the traced step's own on top
        of both: the unrolled loop's last step."""
        outer = self.cost
        # the block's own peak, from the bytes live when it starts
        self.cost = GraphCost(peak_live_bytes=self._live)
        kept, beside = {}, 0

        def resident(*tensors, during_bytes: int = 0):
            nonlocal beside
            for t in tensors:
                kept[storage_key(t)] = t
            beside += during_bytes

        try:
            yield resident
        finally:
            extra = 0
            for key, t in kept.items():
                # n - 1 more of the storage, freed with it (a storage not
                # counted, a step's input, opens a count of them alone)
                if key not in self._counts:
                    self._counts[key] = [0, 0]
                    self._join(t, key)
                count = self._counts[key]
                n_bytes = (n - 1) * base_bytes(t)
                count[0] += n_bytes
                extra += n_bytes
            self._live += extra
            inner = self.cost
            inner.peak_live_bytes = max(
                inner.peak_live_bytes + extra + beside, self._live)
            self.cost = outer + inner.scale(n)

    # DTensor's shape propagation runs the op at global shapes: not counted
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        real = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def hidden(prop, op_schema):
            counter._paused += 1
            try:
                return real(prop, op_schema)
            finally:
                counter._paused -= 1

        self._real_prop = real
        ShardingPropagator._propagate_tensor_meta_non_cached = hidden
        self._fold.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._real_prop
        self._fold.__exit__(*exc)
        return super().__exit__(*exc)

    def _join(self, t: torch.Tensor, key: int) -> None:
        """t aliases the counted storage ``key``: it holds the bytes too."""
        self._counts[key][1] += 1
        weakref.finalize(t, self._leave, key)

    def _leave(self, key: int) -> None:
        count = self._counts[key]
        count[1] -= 1
        if not count[1]:
            self._live -= count[0]
            del self._counts[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        outs = _tensors(out)
        c = self.cost
        if ns in _COLLECTIVE_NS:
            if name in _FREE:
                self._track(outs, ins, alias=True)
                return
            base = name.rstrip("_").removesuffix("_coalesced")
            if base.startswith("all_reduce"):
                cb, key = 2.0 * _nbytes(outs), "all-reduce"
            elif base.startswith("reduce_scatter"):
                cb, key = float(_nbytes(ins)), "reduce-scatter"
            elif base.startswith("all_gather"):
                cb, key = float(_nbytes(outs)), "all-gather"
            elif base.startswith("all_to_all"):
                cb, key = float(_nbytes(outs)), "all-to-all"
            else:
                cb, key = float(_nbytes(outs)), base
            c.collective_bytes += cb
            c.collectives[key] = c.collectives.get(key, 0.0) + cb
            c.bytes += _nbytes(ins) + _nbytes(outs)
            c.ops += 1
            self._track(outs, ins)
            return
        if func.is_view or name in _FREE:
            self._track(outs, ins, alias=True)
            return
        if ns == "prim" or not ins:
            return
        if name in _DOTS:
            c.flops += _dot_flops(name, args, outs[0])
        elif name == "convolution":
            c.flops += _conv_flops(args, outs[0])
        else:
            c.flops += sum(t.numel() for t in outs)
        c.bytes += _nbytes(ins) + _nbytes(outs)
        c.ops += 1
        self._track(outs, ins)

    def _track(self, outs, ins, alias: bool = False) -> None:
        """A result on a counted storage joins its count (an alias, or an
        in-place result); a non-view op's result on a storage none of its
        operands has opens a count of its bytes."""
        in_keys = {storage_key(i) for i in ins}
        for t in outs:
            key = storage_key(t)
            if key in self._counts:
                self._join(t, key)
            elif not alias and key not in in_keys:
                self._counts[key] = [t.numel() * t.element_size(), 0]
                self._live += self._counts[key][0]
                self._join(t, key)
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                        self._live)


def analyze(fn, *args, **kwargs) -> tuple[object, GraphCost]:
    """(fn(*args, **kwargs), the per-device cost of running it)."""
    with GraphCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
