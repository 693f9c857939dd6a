"""Replay a small-batch CNN forward as one CUDA graph.

At batch 1 a ResNet-50 forward is 53 ``carla_conv`` dispatches and a few
PyTorch ops for the pools and the head: milliseconds of Python and ctypes
launches on the host for under one of device work, so the device waits
for the host before every conv.  Captured once, the same chain of the
port's hand-written kernels, under the same plans and in the call's
dtype, replays with one host call and gives the eager forward's bits.

``forward`` decides each call from what the call shows; there is no
option.  It runs eagerly, counting the reason in ``apply.graph_eager``:

  * ``cpu``: x is not on a CUDA device;
  * ``impl``: the engine is not the CUDA kernels (``impl`` other than
    ``auto`` or ``cuda``);
  * ``unfused``: ``fused=False``;
  * ``tracing``: the spans time the eager dispatch, kernel by kernel;
  * ``batch``: more than ``GRAPH_MAX_BATCH`` images, where the device's
    time hides the host's and a graph would hold a large batch's
    activations in a pool of its own;
  * ``new_key``: the call's key differs from the key of the net's
    previous call that a graph could have served.

Otherwise the key repeats: the second call under it captures the forward
(``apply.graph_captures``) and every such call replays it
(``apply.graph_replays``).  At each capture
``apply.graph_programmatic_edges`` takes the captured graph's count of
programmatic dependency edges: the pipelined conv kernels launch as
programmatic dependent launches wherever their grid fills every SM
(``csrc/gemm_pipe.cuh``), which a capture records as such edges, so that a
replay places those convs under their predecessors' tails (52 of ResNet-50's
53 at batch 1).  0 means the capture dropped them.  Likewise
``apply.graph_cluster_kernels`` takes the captured graph's count of kernels
launched in thread block clusters of more than one block: a split conv's
grid whose clusters the device holds at once adds its splits through
distributed shared memory (``csrc/gemm_pipe.cuh``), so the count says how
often that combine runs in a replay.  The key is the net, x's
shape, strides, dtype, device and offset from a 16-byte boundary, ``impl``
and ``fused``, the tuner's state (on or off, and ``autotune.generation()``)
and every weight tensor the forward reads: the same tensor object over the
same storage as when the key was taken.  A weight written in place keeps its
key (the graph reads it where it lies); a weight replaced does not.  A
pruned forward (``cnn.resnet50_apply`` with keep fractions) has the net's
pruned set (``cnn.PrunedSet``) in its key in place of the weight tensors:
the set's lookup, just before, matched every dense weight by object, storage
and version counter, so the weights are walked once a call, and the pruned
tensors the graph reads are the set's own copies.

Each net keeps one entry (``apply.graph_entry``); a new key drops the old
graph and its memory pool.  A captured entry holds the static input, the
static output, the graph (captured on a side stream right after an eager
run under the same key) and the split-K workspace and ticket counters of
``kernels._build`` that the capture recorded, so that a later eager call
that grows them cannot free memory the graph writes.

A replay copies x into the static input, replays on the caller's current
stream and returns a fresh copy of the static output: an answer never
changes under a later call.  Replays and eager calls share the workspace
and the ticket counters, so every call must be ordered on one stream, as
the pipelined kernels' calls always must (``kernels._build``).
"""
from __future__ import annotations

import ctypes
import operator
import weakref
from collections import Counter

import torch

from ..core import autotune
from ..kernels import _build
from ..observability import trace

GRAPH_MAX_BATCH = 8            # images: above it a call runs eagerly
EAGER_REASONS = ("cpu", "impl", "unfused", "tracing", "batch", "new_key")
ALIGN = 16                     # bytes: the kernels' vector loads


def eager_reason(x: torch.Tensor, *, impl: str, fused: bool) -> str | None:
    """Why a call runs eagerly whatever its key (one of
    ``EAGER_REASONS``), or None where a graph may serve it."""
    if not x.is_cuda:
        return "cpu"
    if impl not in ("auto", "cuda"):
        return "impl"
    if not fused:
        return "unfused"
    if trace.enabled():
        return "tracing"
    if x.shape[0] > GRAPH_MAX_BATCH:
        return "batch"
    return None


def weight_tensors(params: dict) -> list:
    """The tensors of a nested dict of weights, in the dict's order."""
    out = []
    _walk(params, out)
    return out


def _walk(tree: dict, out: list) -> None:
    for v in tree.values():
        if isinstance(v, dict):
            _walk(v, out)
        else:
            out.append(v)


def call_key(net: str, params: dict, x: torch.Tensor, impl: str,
             fused: bool, weights=None) -> tuple[tuple, list]:
    """(the call's key but its weight tensors, the weight tensors); with
    ``weights``, an object that stands for the weights (a pruned set),
    that object is in the key and no tensor is."""
    head = (net, x.shape, x.stride(), x.dtype, x.device,
            x.data_ptr() % ALIGN, impl, fused, autotune.enabled(),
            autotune.generation())
    if weights is not None:
        return (*head, weights), []
    return head, weight_tensors(params)


class Entry:
    """One net's key and, once captured, its graph.

    The weights are held by weak reference: an entry keeps no weight
    alive, and a weight freed and another allocated in its place never
    matches."""

    __slots__ = ("head", "refs", "ptrs", "graph")

    def __init__(self, head: tuple, tensors: list):
        self.head = head
        self.refs = [weakref.ref(t) for t in tensors]
        self.ptrs = [t.data_ptr() for t in tensors]
        self.graph: Graph | None = None

    def matches(self, head: tuple, tensors: list) -> bool:
        """Whether a call of this key (``call_key``) may replay the graph."""
        return (head == self.head and len(tensors) == len(self.refs)
                and all(map(operator.is_, tensors,
                            [ref() for ref in self.refs]))
                and list(map(torch.Tensor.data_ptr, tensors)) == self.ptrs)


def _static_input(x: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor of x's shape and dtype, on x's device,
    at x's offset from a 16-byte boundary (the kernels' plans read the
    alignment)."""
    item = x.element_size()
    offset = x.data_ptr() % ALIGN // item
    buf = torch.empty(x.numel() + ALIGN // item, dtype=x.dtype,
                      device=x.device)
    return buf[offset:offset + x.numel()].view(x.shape)


class _EdgeData(ctypes.Structure):
    """libcuda's ``CUgraphEdgeData``."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


PROGRAMMATIC = 1               # CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC


def programmatic_edges(raw_graph: int) -> int:
    """The dependency edges of programmatic type in a ``cudaGraph_t``
    (``CUDAGraph.raw_cuda_graph()``), read with libcuda's
    ``cuGraphGetEdges_v2`` (CUDA 12.3 on)."""
    get = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    get.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    _libcuda_check(get(raw_graph, None, None, None, ctypes.byref(n)))
    nodes = ctypes.c_void_p * n.value
    frm, to, data = nodes(), nodes(), (_EdgeData * n.value)()
    _libcuda_check(get(raw_graph, frm, to, data, ctypes.byref(n)))
    return sum(e.type == PROGRAMMATIC for e in data[:n.value])


def _libcuda_check(err: int, what: str = "cuGraphGetEdges_v2") -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUresult {err}")


KERNEL_NODE = 0                # CU_GRAPH_NODE_TYPE_KERNEL
CLUSTER_DIMENSION = 4          # CU_LAUNCH_ATTRIBUTE_CLUSTER_DIMENSION


class _AttrValue(ctypes.Union):
    """libcuda's ``CUlaunchAttributeValue`` (64 bytes); its cluster
    dimension is three unsigned ints at the start."""
    _fields_ = [("cluster_dim", ctypes.c_uint * 3),
                ("pad", ctypes.c_char * 64)]


def cluster_kernels(raw_graph: int) -> int:
    """The kernel nodes of a ``cudaGraph_t`` launched in clusters of more
    than one block, read with libcuda's ``cuGraphGetNodes``,
    ``cuGraphNodeGetType`` and ``cuGraphKernelNodeGetAttribute``."""
    lib = ctypes.CDLL("libcuda.so.1")
    get_nodes, get_type, get_attr = (lib.cuGraphGetNodes,
                                     lib.cuGraphNodeGetType,
                                     lib.cuGraphKernelNodeGetAttribute)
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_attr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                         ctypes.POINTER(_AttrValue)]
    n = ctypes.c_size_t(0)
    _libcuda_check(get_nodes(raw_graph, None, ctypes.byref(n)),
                   "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _libcuda_check(get_nodes(raw_graph, nodes, ctypes.byref(n)),
                   "cuGraphGetNodes")
    count = 0
    for node in nodes[:n.value]:
        kind, value = ctypes.c_int(-1), _AttrValue()
        _libcuda_check(get_type(node, ctypes.byref(kind)),
                       "cuGraphNodeGetType")
        if kind.value != KERNEL_NODE:
            continue
        _libcuda_check(get_attr(node, CLUSTER_DIMENSION, ctypes.byref(value)),
                       "cuGraphKernelNodeGetAttribute")
        x, y, z = value.cluster_dim
        count += x * y * z > 1
    return count


class Graph:
    """A forward captured on a side stream: its static input and output,
    the shared scratch its kernels write, and its counts of programmatic
    edges and of kernels launched in clusters."""

    def __init__(self, run, x: torch.Tensor):
        dev = x.device
        self.x = _static_input(x)
        self.x.copy_(x)
        before = (_build._partials.get(dev), _build._tickets.get(dev))
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            self.y = run(self.x)
        self.scratch = (*before, _build._partials.get(dev),
                        _build._tickets.get(dev))
        self.programmatic_edges = programmatic_edges(
            self.graph.raw_cuda_graph())
        self.cluster_kernels = cluster_kernels(self.graph.raw_cuda_graph())
        self.graph.instantiate()

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of x: a fresh tensor, on the current stream."""
        self.x.copy_(x)
        self.graph.replay()
        return self.y.clone()


def reset(apply) -> None:
    """Zero ``apply``'s counters and drop its net's graph and pruned set."""
    apply.graph_captures = 0
    apply.graph_programmatic_edges = 0
    apply.graph_cluster_kernels = 0
    apply.graph_replays = 0
    apply.graph_eager = Counter()
    apply.graph_entry = None
    apply.prunes = 0
    apply.prune_hits = 0
    apply.prune_entry = None


def forward(apply, run, params: dict, x: torch.Tensor, *, impl: str,
            fused: bool, weights=None) -> torch.Tensor:
    """``run(x)``, the forward of ``apply`` (``cnn.resnet50_apply`` or
    ``cnn.vgg16_apply``) on ``params`` (or on the pruned set ``weights``):
    eager, captured or replayed as the module's docstring says, counted on
    ``apply``."""
    reason = eager_reason(x, impl=impl, fused=fused)
    if reason is not None:
        apply.graph_eager[reason] += 1
        return run(x)
    head, tensors = call_key(apply.__name__, params, x, impl, fused, weights)
    entry = apply.graph_entry
    if entry is None or not entry.matches(head, tensors):
        apply.graph_entry = None
        apply.graph_eager["new_key"] += 1
        out = run(x)
        apply.graph_entry = Entry(head, tensors)
        return out
    if entry.graph is None:
        entry.graph = Graph(run, x)
        apply.graph_captures += 1
        apply.graph_programmatic_edges = entry.graph.programmatic_edges
        apply.graph_cluster_kernels = entry.graph.cluster_kernels
    apply.graph_replays += 1
    return entry.graph.replay(x)
