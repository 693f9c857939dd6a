"""The CNN forward replayed as one CUDA graph (``models.cnn_graph``).

On the CPU: the rule that decides a call (each eager reason), the key
(what changes it and what does not), the forward's control flow with a
stand-in for the graph, the pruned forward's set (pruned once, pruned
again when a weight or the keep fractions change, holding no weight), the
static input's alignment, and the batch limit against the benchmark's
traffic.  On the card (``chip``, skipped without one), at the
single-stream cells' size: replayed logits equal the eager logits bit for
bit (ResNet-50 dense and pruned, and VGG-16, batch 1, fp32 and bf16,
inputs at and off a 16-byte boundary), answers stay put, a replaced or
written weight is captured again, an eager call that regrows the shared
workspace leaves the replay alone, tracing runs eagerly, the profiler
sees every kernel of a replay, a captured forward holds the
programmatic edges of its chained convs, and ResNet-50's holds split
convs launched in thread block clusters.

    PYTHONPATH=src python -m pytest -q tests/test_torch_cnn_graph.py
"""
import contextlib
import ctypes
import gc
import json
import types
import weakref
from pathlib import Path

import pytest
import torch

from repro_torch.core import autotune
from repro_torch.core.autotune import TileConfig
from repro_torch.kernels import _build
from repro_torch.models import cnn, cnn_graph
from repro_torch.observability import trace

TRAFFIC = Path(__file__).resolve().parent.parent / "portbench" / "traffic"
APPLY = {"resnet50": cnn.resnet50_apply, "vgg16": cnn.vgg16_apply}
INIT = {"resnet50": cnn.resnet50_init, "vgg16": cnn.vgg16_init}
CONVS = {"resnet50": 53, "vgg16": 13}
# device ops of a replayed single-stream step: the eager forward's and its
# logits' copy to the host (59 and 21), the input's copy and the output's
DEVICE_OPS = {"resnet50": 61, "vgg16": 23}


def _fake_x(batch: int, is_cuda: bool = True):
    """What ``eager_reason`` reads of x."""
    return types.SimpleNamespace(is_cuda=is_cuda, shape=(batch, 224, 224, 3))


DENSE = dict(impl="auto", fused=True)


@pytest.mark.parametrize("change,reason", [
    ({}, None),
    ({"impl": "cuda"}, None),
    ({"batch": cnn_graph.GRAPH_MAX_BATCH}, None),
    ({"is_cuda": False}, "cpu"),
    ({"impl": "ref"}, "impl"),
    ({"fused": False}, "unfused"),
    ({"impl": "cuda", "fused": False}, "unfused"),
    ({"tracing": True}, "tracing"),
    ({"batch": cnn_graph.GRAPH_MAX_BATCH + 1}, "batch"),
    ({"batch": 64, "is_cuda": False}, "cpu"),
])
def test_eager_reason(change, reason):
    change = dict(change)
    x = _fake_x(change.pop("batch", 1), change.pop("is_cuda", True))
    tracing = change.pop("tracing", False)
    with trace.capture() if tracing else contextlib.nullcontext():
        assert cnn_graph.eager_reason(x, **{**DENSE, **change}) == reason
    assert reason is None or reason in cnn_graph.EAGER_REASONS


def test_graph_max_batch_is_below_the_offline_traffics():
    """Both offline cells (b64, b16) stay on the eager path, whose
    per-dispatch launches their route rooflines read; single stream
    replays."""
    batches = {}
    for path in sorted(TRAFFIC.glob("*.json")):
        t = json.loads(path.read_text())
        batches.setdefault(t["scenario"], []).append(t["batch"])
    assert batches["offline"] and batches["single_stream"]
    assert all(b > cnn_graph.GRAPH_MAX_BATCH for b in batches["offline"])
    assert all(b <= cnn_graph.GRAPH_MAX_BATCH
               for b in batches["single_stream"])


@pytest.fixture
def small():
    params = cnn.resnet50_init(torch.Generator().manual_seed(0),
                               width=0.0625, device="cpu")
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    return params, x


def _key(params, x, impl="auto", fused=True):
    return cnn_graph.call_key("resnet50_apply", params, x, impl, fused)


def _replace(params, path):
    out = dict(params)
    node = out
    for k in path[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[path[-1]] = node[path[-1]].clone()
    return out


@pytest.mark.parametrize("what", [
    "conv weight replaced", "bn vector replaced", "fc replaced",
    "storage swapped", "x shape", "x dtype", "x strides", "x alignment",
    "impl", "fused", "tuner enabled", "tuner generation"])
def test_the_key_changes(small, what):
    params, x = small
    entry = cnn_graph.Entry(*_key(params, x))
    assert entry.matches(*_key(params, x))
    args = {"impl": "auto", "fused": True}
    try:
        if what == "conv weight replaced":
            params = _replace(params, ("conv3_b1", "c2"))
        elif what == "bn vector replaced":
            params = _replace(params, ("conv5_b2", "bn3", "bias"))
        elif what == "fc replaced":
            params = _replace(params, ("fc", "w"))
        elif what == "storage swapped":
            w = params["conv1"]
            w.data = w.data.clone()
        elif what == "x shape":
            x = torch.randn(2, 32, 32, 3)
        elif what == "x dtype":
            x = x.bfloat16()
        elif what == "x strides":
            x = x.permute(0, 2, 1, 3)
        elif what == "x alignment":
            x = torch.randn(x.numel() + 1)[1:].view(x.shape)
        elif what == "impl":
            args["impl"] = "cuda"
        elif what == "fused":
            args["fused"] = False
        elif what == "tuner enabled":
            autotune.enable()
        elif what == "tuner generation":
            autotune.put("conv2d|test_the_key_changes", TileConfig(1, 1))
        assert not entry.matches(*_key(params, x, **args))
    finally:
        autotune.disable()
        autotune.reset()


@pytest.mark.parametrize("what", ["fresh x of the same layout",
                                  "weight written in place",
                                  "a copy of the params dict"])
def test_the_key_holds(small, what):
    params, x = small
    entry = cnn_graph.Entry(*_key(params, x))
    if what == "fresh x of the same layout":
        x = torch.randn(x.shape)
    elif what == "weight written in place":
        params["conv2_b0"]["c1"].mul_(2)
    else:
        params = {k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in params.items()}
    assert entry.matches(*_key(params, x))


def test_an_entry_keeps_no_weight_alive():
    params = cnn.resnet50_init(width=0.0625, device="cpu")
    x = torch.randn(1, 32, 32, 3)
    entry = cnn_graph.Entry(*_key(params, x))
    assert len(entry.refs) == len(cnn_graph.weight_tensors(params)) == 160
    del params
    gc.collect()
    assert all(ref() is None for ref in entry.refs)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_input_keeps_the_alignment(offset, dtype):
    x = torch.randn(3 * 8 * 8 * 3 + offset, dtype=dtype)[offset:]
    x = x.view(3, 8, 8, 3)
    s = cnn_graph._static_input(x)
    assert s.shape == x.shape and s.dtype == x.dtype and s.is_contiguous()
    assert s.data_ptr() % cnn_graph.ALIGN == x.data_ptr() % cnn_graph.ALIGN


@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_a_cpu_forward_never_captures(net):
    apply = APPLY[net]
    params = INIT[net](torch.Generator().manual_seed(0), width=0.0625,
                       device="cpu")
    x = torch.randn(1, 32, 32, 3)
    cnn_graph.reset(apply)
    first = apply(params, x)
    for _ in range(3):
        assert torch.equal(apply(params, x), first)
    assert apply.graph_captures == apply.graph_replays == 0
    assert apply.graph_eager == {"cpu": 4}
    assert apply.graph_entry is None


class _StandIn:
    """A CPU stand-in for ``cnn_graph.Graph``: "captures" by running once on
    its static input, "replays" by running again into its static output,
    and reports ``edges`` programmatic edges and ``clusters`` kernels
    launched in clusters."""

    made = 0
    edges = 0
    clusters = 0

    def __init__(self, run, x):
        _StandIn.made += 1
        self.programmatic_edges = _StandIn.edges
        self.cluster_kernels = _StandIn.clusters
        self.run = run
        self.x = cnn_graph._static_input(x)
        self.x.copy_(x)
        self.y = run(self.x)

    def replay(self, x):
        self.x.copy_(x)
        self.y.copy_(self.run(self.x))
        return self.y.clone()


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """``cnn_graph.forward`` treating CPU tensors as CUDA ones, with the
    stand-in graph."""
    rule = cnn_graph.eager_reason

    def on_cpu(x, **kw):
        return rule(types.SimpleNamespace(is_cuda=True, shape=x.shape), **kw)
    monkeypatch.setattr(cnn_graph, "eager_reason", on_cpu)
    monkeypatch.setattr(cnn_graph, "Graph", _StandIn)
    monkeypatch.setattr(_StandIn, "made", 0)
    monkeypatch.setattr(_StandIn, "edges", 0)
    monkeypatch.setattr(_StandIn, "clusters", 0)
    yield
    for apply in APPLY.values():
        cnn_graph.reset(apply)


@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_second_call_captures_then_every_call_replays(graphs_on_cpu, net):
    apply = APPLY[net]
    params = INIT[net](torch.Generator().manual_seed(0), width=0.0625,
                       device="cpu")
    xs = [torch.randn(1, 32, 32, 3) for _ in range(4)]
    cnn_graph.reset(apply)
    want = [apply(params, x, impl="ref") for x in xs]
    assert apply.graph_eager == {"impl": 4}
    got = [apply(params, x) for x in xs]
    assert (apply.graph_eager["new_key"], apply.graph_captures,
            apply.graph_replays) == (1, 1, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # answers are fresh tensors: a later call leaves an earlier one alone
    kept = got[1].clone()
    apply(params, xs[3])
    assert torch.equal(got[1], kept)
    assert got[1].data_ptr() != apply.graph_entry.graph.y.data_ptr()
    # calls the graph cannot serve run eagerly and keep the entry
    with trace.capture() as tr:
        apply(params, xs[0])
    assert sum(s.name == "kernels.conv2d" or s.name == "kernels.conv1x1"
               for root in tr.spans for s in root.walk()) == CONVS[net]
    apply(params, torch.randn(cnn_graph.GRAPH_MAX_BATCH + 1, 32, 32, 3))
    apply(params, xs[0], fused=False)
    assert apply.graph_eager["tracing"] == apply.graph_eager["batch"] == \
        apply.graph_eager["unfused"] == 1
    replays = apply.graph_replays
    assert torch.equal(apply(params, xs[2]), want[2])
    assert (apply.graph_replays, _StandIn.made) == (replays + 1, 1)


@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_programmatic_edges_stay_zero_without_a_capture(net):
    """A CPU forward, and every eager reason, leave the count at 0."""
    apply = APPLY[net]
    params = INIT[net](torch.Generator().manual_seed(0), width=0.0625,
                       device="cpu")
    x = torch.randn(1, 32, 32, 3)
    apply.graph_programmatic_edges = 7
    cnn_graph.reset(apply)
    assert apply.graph_programmatic_edges == 0
    apply(params, x)
    apply(params, x, impl="ref")
    apply(params, x, fused=False)
    with trace.capture():
        apply(params, x)
    assert apply.graph_programmatic_edges == apply.graph_captures == 0


@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_a_capture_takes_its_graphs_programmatic_edges(graphs_on_cpu, net):
    """Each capture sets the count to its graph's (not a running sum);
    eager calls and replays leave it, and ``reset`` zeroes it."""
    apply = APPLY[net]
    params = INIT[net](torch.Generator().manual_seed(0), width=0.0625,
                       device="cpu")
    x = torch.randn(1, 32, 32, 3)
    cnn_graph.reset(apply)
    _StandIn.edges = 52
    apply(params, x)
    assert apply.graph_programmatic_edges == 0          # eager: new key
    for _ in range(3):
        apply(params, x)
    assert (apply.graph_captures, apply.graph_programmatic_edges) == (1, 52)
    apply(params, x, impl="ref")
    _StandIn.edges = 9
    x2 = torch.randn(2, 32, 32, 3)                      # a new key
    for _ in range(2):
        apply(params, x2)
    assert (apply.graph_captures, apply.graph_programmatic_edges) == (2, 9)
    cnn_graph.reset(apply)
    assert apply.graph_programmatic_edges == 0


class _FakeLibcuda:
    """``libcuda``'s ``cuGraphGetEdges_v2`` over a list of edge types, as
    a C function: all-NULL arrays ask for the count."""

    PROTO = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_size_t))

    def __init__(self, types, err=0):
        self.types, self.err, self.graphs = types, err, []
        self.cuGraphGetEdges_v2 = self.PROTO(self._get)

    def _get(self, graph, frm, to, data, n):
        self.graphs.append(graph)
        if self.err:
            return self.err
        if data is None:
            assert frm is None and to is None
        else:
            assert frm is not None and to is not None
            assert n[0] == len(self.types)
            out = ctypes.cast(data, ctypes.POINTER(cnn_graph._EdgeData))
            for i, t in enumerate(self.types):
                out[i].type = t
        n[0] = len(self.types)
        return 0


@pytest.mark.parametrize("types,want", [
    ([], 0), ([0, 0, 0], 0), ([1], 1), ([0, 1, 1, 0, 1, 2], 3)])
def test_programmatic_edges_counts_the_edges_libcuda_reports(monkeypatch, types,
                                                     want):
    fake = _FakeLibcuda(types)
    monkeypatch.setattr(cnn_graph.ctypes, "CDLL", lambda name: fake)
    assert ctypes.sizeof(cnn_graph._EdgeData) == 8
    assert cnn_graph.programmatic_edges(0x1234) == want
    assert fake.graphs == [0x1234, 0x1234]


def test_programmatic_edges_raises_on_a_libcuda_error(monkeypatch):
    fake = _FakeLibcuda([1], err=801)
    monkeypatch.setattr(cnn_graph.ctypes, "CDLL", lambda name: fake)
    with pytest.raises(RuntimeError, match="CUresult 801"):
        cnn_graph.programmatic_edges(0x1234)


@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_a_capture_takes_its_graphs_cluster_kernels(graphs_on_cpu, net):
    """As the programmatic edges: each capture sets the count to its
    graph's, eager calls and replays leave it, ``reset`` zeroes it."""
    apply = APPLY[net]
    params = INIT[net](torch.Generator().manual_seed(0), width=0.0625,
                       device="cpu")
    x = torch.randn(1, 32, 32, 3)
    apply.graph_cluster_kernels = 7
    cnn_graph.reset(apply)
    assert apply.graph_cluster_kernels == 0
    _StandIn.clusters = 43
    apply(params, x)
    assert apply.graph_cluster_kernels == 0             # eager: new key
    for _ in range(3):
        apply(params, x)
    assert (apply.graph_captures, apply.graph_cluster_kernels) == (1, 43)
    apply(params, x, impl="ref")
    with trace.capture():
        apply(params, x)
    assert apply.graph_cluster_kernels == 43
    _StandIn.clusters = 3
    x2 = torch.randn(2, 32, 32, 3)                      # a new key
    for _ in range(2):
        apply(params, x2)
    assert (apply.graph_captures, apply.graph_cluster_kernels) == (2, 3)
    cnn_graph.reset(apply)
    assert apply.graph_cluster_kernels == 0


class _FakeGraphNodes:
    """``libcuda``'s ``cuGraphGetNodes``, ``cuGraphNodeGetType`` and
    ``cuGraphKernelNodeGetAttribute`` over a list of nodes, each a node
    type and a cluster dimension, as C functions."""

    NODES = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_size_t))
    TYPE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int))
    ATTR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.POINTER(cnn_graph._AttrValue))

    def __init__(self, nodes, err=0):
        self.nodes, self.err, self.asked = nodes, err, []
        self.cuGraphGetNodes = self.NODES(self._nodes)
        self.cuGraphNodeGetType = self.TYPE(self._type)
        self.cuGraphKernelNodeGetAttribute = self.ATTR(self._attr)

    def _nodes(self, graph, out, n):
        assert graph == 0x1234
        if out is not None:
            assert n[0] == len(self.nodes)
            arr = ctypes.cast(out, ctypes.POINTER(ctypes.c_void_p))
            for i in range(len(self.nodes)):
                arr[i] = i + 1
        n[0] = len(self.nodes)
        return 0

    def _type(self, node, kind):
        kind[0] = self.nodes[node - 1][0]
        return 0

    def _attr(self, node, attr, value):
        self.asked.append((node, attr))
        if self.err:
            return self.err
        value[0].cluster_dim[:] = self.nodes[node - 1][1]
        return 0


KERNEL, MEMCPY = 0, 1


@pytest.mark.parametrize("nodes,want", [
    ([], 0),
    ([(KERNEL, (0, 0, 0)), (KERNEL, (1, 1, 1))], 0),
    ([(KERNEL, (1, 1, 8)), (MEMCPY, (0, 0, 0)), (KERNEL, (1, 1, 1)),
      (KERNEL, (1, 1, 2)), (KERNEL, (2, 1, 1))], 3)])
def test_cluster_kernels_counts_the_kernels_libcuda_reports(monkeypatch,
                                                           nodes, want):
    fake = _FakeGraphNodes(nodes)
    monkeypatch.setattr(cnn_graph.ctypes, "CDLL", lambda name: fake)
    assert ctypes.sizeof(cnn_graph._AttrValue) == 64
    assert cnn_graph.cluster_kernels(0x1234) == want
    # the attribute is asked of kernel nodes only, for the cluster dimension
    assert fake.asked == [(i + 1, cnn_graph.CLUSTER_DIMENSION)
                          for i, (t, _) in enumerate(nodes) if t == KERNEL]


def test_cluster_kernels_raises_on_a_libcuda_error(monkeypatch):
    fake = _FakeGraphNodes([(KERNEL, (1, 1, 2))], err=1)
    monkeypatch.setattr(cnn_graph.ctypes, "CDLL", lambda name: fake)
    with pytest.raises(RuntimeError,
                       match="cuGraphKernelNodeGetAttribute failed with "
                             "CUresult 1"):
        cnn_graph.cluster_kernels(0x1234)


def test_a_replaced_weight_is_captured_again(graphs_on_cpu, small):
    params, x = small
    apply = cnn.resnet50_apply
    cnn_graph.reset(apply)
    for _ in range(3):
        apply(params, x)
    new = _replace(params, ("conv4_b3", "c3"))
    new["conv4_b3"]["c3"].mul_(-1)
    outs = [apply(new, x) for _ in range(3)]
    assert (apply.graph_eager["new_key"], apply.graph_captures,
            apply.graph_replays) == (2, 2, 4)
    want = apply(new, x, impl="ref")
    assert all(torch.equal(o, want) for o in outs)


PRUNED = {"sparse": {"sparse": True}, "keep 0.5": {"keep_fractions": 0.5},
          "keep by group": {"keep_fractions": {"conv3": 0.5, "conv5": 0.25}}}


@pytest.mark.parametrize("kw", list(PRUNED))
def test_the_pruned_forward_prunes_once_then_replays(graphs_on_cpu, small,
                                                     kw):
    params, x = small
    kw = PRUNED[kw]
    apply = cnn.resnet50_apply
    cnn_graph.reset(apply)
    keep = kw.get("keep_fractions", 0.5)
    pre = cnn.resnet50_prune(params, keep)[0]
    want = apply(pre, x, impl="ref")                 # no pruned set: dense
    assert (apply.prunes, apply.prune_hits) == (0, 0)
    outs = [apply(params, x, **kw) for _ in range(6)]
    assert all(torch.equal(o, want) for o in outs)
    assert (apply.graph_eager["new_key"], apply.graph_captures,
            apply.graph_replays) == (1, 1, 5)
    assert (apply.prunes, apply.prune_hits) == (1, 5)
    assert "sparse" not in cnn_graph.EAGER_REASONS
    # the graph reads the set's copies, and the key holds the set
    entry = apply.prune_entry
    assert entry in apply.graph_entry.head
    assert apply.graph_entry.refs == []
    # the eager engine shares the set
    assert torch.equal(apply(params, x, impl="ref", **kw), want)
    assert (apply.prunes, apply.prune_hits) == (1, 6)
    # a dense call of the same weights neither prunes nor reads the set
    apply(params, x)
    assert apply.prunes == 1 and apply.prune_entry is entry


def _write_in_place(params, kw):
    params["conv4_b2"]["c1"].mul_(-1)
    return params, kw


def _write_bn_in_place(params, kw):
    params["conv2_b1"]["bn2"]["scale"].add_(1)
    return params, kw


def _replace_weight(params, kw):
    new = _replace(params, ("conv5_b0", "c2"))
    new["conv5_b0"]["c2"].mul_(-1)
    return new, kw


def _draw_again(params, kw):
    return cnn.resnet50_init(torch.Generator().manual_seed(5),
                             width=0.0625, device="cpu"), kw


def _change_keep(params, kw):
    return params, {"keep_fractions": {"conv2": 0.25, "conv4": 0.5}}


@pytest.mark.parametrize("change", [_write_in_place, _write_bn_in_place,
                                    _replace_weight, _draw_again,
                                    _change_keep])
def test_a_changed_weight_set_is_pruned_again(graphs_on_cpu, small, change):
    params, x = small
    apply = cnn.resnet50_apply
    cnn_graph.reset(apply)
    kw = {"keep_fractions": 0.5}
    for _ in range(3):
        apply(params, x, **kw)
    params, kw = change(params, kw)
    outs = [apply(params, x, **kw) for _ in range(3)]
    assert (apply.prunes, apply.prune_hits) == (2, 4)
    assert (apply.graph_eager["new_key"], apply.graph_captures,
            apply.graph_replays) == (2, 2, 4)
    pre = cnn.resnet50_prune(params, kw["keep_fractions"])[0]
    want = apply(pre, x, impl="ref")
    assert all(torch.equal(o, want) for o in outs)


def test_a_pruned_set_keeps_no_weight_alive():
    params = cnn.resnet50_init(width=0.0625, device="cpu")
    x = torch.randn(1, 32, 32, 3)
    apply = cnn.resnet50_apply
    cnn_graph.reset(apply)
    apply(params, x, sparse=True)
    entry = apply.prune_entry
    dense = {id(t) for t in cnn_graph.weight_tensors(params)}
    assert len(entry.weights.refs) == len(dense) == 160
    assert len(entry.blocks) == 16 and len(entry.tags) == 48
    assert not dense & {id(t) for t in cnn_graph.weight_tensors(entry.blocks)}
    del params
    gc.collect()
    assert all(ref() is None for ref in entry.weights.refs)
    cnn_graph.reset(apply)


def test_a_traced_pruned_forward_runs_eagerly(graphs_on_cpu, small):
    params, x = small
    apply = cnn.resnet50_apply
    cnn_graph.reset(apply)
    for _ in range(3):
        apply(params, x, sparse=True)
    for hit in (True, False):
        if not hit:
            params["conv1"].mul_(1)                 # a write: prune again
        with trace.capture() as tr:
            apply(params, x, sparse=True)
        (root,) = tr.spans
        prune, *rest = root.children
        assert (prune.name, prune.attrs["hit"]) == ("cnn.prune", hit)
        assert prune.attrs["keep"] == dict.fromkeys(cnn.RESNET50_BLOCKS, 0.5)
        convs = [s for s in root.walk() if s.name == "carla_conv"]
        tagged = [s for s in convs if s.attrs.get("pruned")]
        assert (len(convs), len(tagged)) == (53, 48)
        assert all(0 < s.attrs["keep_fraction"] < 1 and
                   s.attrs["dense_twin_macs"] > s.attrs["macs"]
                   for s in tagged)
    assert apply.graph_eager["tracing"] == 2 and apply.graph_replays == 2
    assert (apply.prunes, apply.prune_hits) == (2, 3)


def test_tuner_generation_counts_every_change():
    try:
        g = autotune.generation()
        autotune.reset()
        assert autotune.generation() == g + 1
        autotune.lookup_gemm(1, 16, 16, "float32")     # loads the tables
        assert autotune.generation() == g + 2
        autotune.lookup_gemm(1, 16, 16, "float32")
        assert autotune.generation() == g + 2
        autotune.put("conv2d|test_tuner_generation", TileConfig(1, 1))
        assert autotune.generation() == g + 3
    finally:
        autotune.reset()


# ----------------------------------------------------------- on the card ---
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_net(net: str, dtype, seed: int = 0):
    """Full-width weights with drawn BN; weights in ``dtype``, the folded
    BN vectors in fp32 (as the benchmark's bf16 engine runs them)."""
    params = INIT[net](torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def fix(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fix(v)
            elif k == "scale":
                tree[k] = torch.rand(v.shape, generator=gen,
                                     device="cuda") + 0.5
            elif k == "bias":
                tree[k] = torch.rand(v.shape, generator=gen,
                                     device="cuda") - 0.5
            else:
                tree[k] = v.to(dtype)
    fix(params)
    return params


def _card_inputs(dtype, n: int = 3):
    """n images of a pool at 16-byte boundaries and one a single element
    off one."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    pool = torch.randn((n, 224, 224, 3), generator=gen, device="cuda")
    flat = torch.randn(224 * 224 * 3 + 1, generator=gen, device="cuda")
    pool, flat = pool.to(dtype), flat.to(dtype)
    off = flat[1:].view(1, 224, 224, 3)
    assert off.data_ptr() % cnn_graph.ALIGN
    return [pool[i:i + 1] for i in range(n)], off


def _eager(apply, params, x, **kw):
    """The eager forward: with tracing on no call replays."""
    with trace.capture():
        return apply(params, x, **kw)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_replayed_logits_equal_eager_bits(cuda, net, dtype):
    apply, params = APPLY[net], _card_net(net, dtype)
    aligned, off = _card_inputs(dtype)
    cnn_graph.reset(apply)
    answers = []
    for xs in (aligned, [off] * 3):
        want = [_eager(apply, params, x) for x in xs]
        answers += zip([apply(params, x) for x in xs], want)
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for got, want in answers)
    assert not torch.equal(answers[0][0], answers[1][0])
    assert (apply.graph_eager["new_key"], apply.graph_captures,
            apply.graph_replays) == (2, 2, 4)
    # an earlier answer is unchanged by later calls
    for x in aligned:
        apply(params, x)
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for got, want in answers)


@pytest.mark.chip
def test_a_replaced_weight_is_captured_again_on_the_card(cuda):
    apply, params = cnn.resnet50_apply, _card_net("resnet50", torch.float32)
    (x, *_), _ = _card_inputs(torch.float32)
    cnn_graph.reset(apply)
    for _ in range(3):
        apply(params, x)
    new = _replace(params, ("conv3_b2", "c2"))
    new["conv3_b2"]["c2"].mul_(0.5)
    outs = [apply(new, x) for _ in range(3)]
    want = _eager(apply, new, x)
    torch.cuda.synchronize()
    assert apply.graph_captures == 2
    assert all(torch.equal(o, want) for o in outs)
    assert not torch.equal(want, _eager(apply, params, x))


@pytest.mark.chip
def test_an_eager_call_that_regrows_the_workspace_leaves_replays(cuda):
    """A b64 call runs eagerly; where it grows the shared split-K workspace
    (dropped here first, as a grow drops the smaller one) the graph keeps
    the one it recorded alive, so neither its replay nor the b64 answer
    changes."""
    apply, params = cnn.resnet50_apply, _card_net("resnet50", torch.float32)
    (x, *_), _ = _card_inputs(torch.float32)
    cnn_graph.reset(apply)
    apply(params, x)
    first = apply(params, x)
    recorded = weakref.ref(_build._partials.pop(x.device))
    _build._tickets.pop(x.device)
    big = torch.randn((64, 224, 224, 3), device="cuda")
    y64 = apply(params, big)
    _eager(apply, params, x)            # grows it again at batch 1
    kept = y64.clone()
    del big
    gc.collect()
    again = apply(params, x)
    torch.cuda.synchronize()
    assert apply.graph_eager["batch"] == 1 and apply.graph_replays == 2
    assert recorded() is not None
    assert any(t is recorded() for t in apply.graph_entry.graph.scratch)
    assert _build._partials[x.device] is not recorded()
    assert torch.equal(again, first) and torch.equal(y64, kept)


@pytest.mark.chip
@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_tracing_runs_eagerly(cuda, net):
    apply, params = APPLY[net], _card_net(net, torch.float32)
    (x, *_), _ = _card_inputs(torch.float32)
    cnn_graph.reset(apply)
    apply(params, x)
    apply(params, x)
    with trace.capture() as tr:
        apply(params, x)
    (root,) = tr.spans
    assert root.name == "cnn.forward"
    assert sum(s.name == "kernels.launch" for s in root.walk()) == CONVS[net]
    assert apply.graph_eager["tracing"] == 1 and apply.graph_replays == 1


def _profile(step, n: int):
    """(device ops, busy seconds) per step of n steps under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        busy += e - s if end is None else max(0.0, e - max(s, end))
        end = e if end is None else max(end, e)
    return len(spans) / n, busy / 1e6 / n


@pytest.mark.chip
@pytest.mark.parametrize("net", ["resnet50", "vgg16", "resnet50_sparse"])
def test_the_profiler_sees_every_kernel_of_a_replay(cuda, net):
    kw = {"keep_fractions": 0.5} if net.endswith("_sparse") else {}
    net = net.removesuffix("_sparse")
    apply, params = APPLY[net], _card_net(net, torch.float32)
    (x, *_), _ = _card_inputs(torch.float32)
    host = torch.empty((1, 1000), pin_memory=True)
    cnn_graph.reset(apply)
    for _ in range(3):
        apply(params, x, **kw)
    torch.cuda.synchronize()

    def replay():
        host.copy_(apply(params, x, **kw), non_blocking=True)

    def eager():
        host.copy_(_eager(apply, params, x, **kw), non_blocking=True)

    _profile(replay, 2)                  # the profiler's start-up
    n = 20
    eager_ops, eager_busy = _profile(eager, n)
    replay_ops, replay_busy = _profile(replay, n)
    assert apply.graph_replays >= n
    assert replay_ops == eager_ops + 2 == DEVICE_OPS[net]
    # the same work; replayed, the convs launched early overlap their
    # predecessors' tails (the eager host enqueues each too late for that):
    # 0.930-0.940 (ResNet-50 dense and pruned) and 0.963-0.993 (VGG-16) on
    # the H100, with 0.03 of room on either side
    assert 0.90 < replay_busy / eager_busy < 1.02


# least programmatic edges of a captured forward at batch 1: one into every
# conv after another kernel whose launch fills every SM to its occupancy
# (csrc/gemm_pipe.cuh: fills_every_sm). ResNet-50: the 52 convs after the
# stem, all 64x64 tiles of four groups, one block an SM; pruned, 49, since
# conv2's three 1x1b run 196 blocks of a tile six fit an SM; VGG-16: 9, all
# but the first conv and conv4's three (520 blocks of six an SM).
LEAST_PROGRAMMATIC_EDGES = {"resnet50": 51, "resnet50_sparse": 49,
                            "vgg16": 8}


@pytest.mark.chip
@pytest.mark.parametrize("case", ["resnet50", "vgg16", "resnet50_sparse"])
def test_a_captured_forward_holds_programmatic_edges(cuda, case):
    kw = {"keep_fractions": 0.5} if case.endswith("_sparse") else {}
    net = case.removesuffix("_sparse")
    apply, params = APPLY[net], _card_net(net, torch.float32)
    (x, *_), _ = _card_inputs(torch.float32)
    cnn_graph.reset(apply)
    for _ in range(3):
        apply(params, x, **kw)
    torch.cuda.synchronize()
    edges = apply.graph_programmatic_edges
    assert apply.graph_captures == 1
    assert edges == apply.graph_entry.graph.programmatic_edges
    assert LEAST_PROGRAMMATIC_EDGES[case] <= edges <= CONVS[net]
    cnn_graph.reset(apply)
    assert apply.graph_programmatic_edges == 0


@pytest.mark.chip
def test_a_captured_resnet50_holds_split_convs_in_clusters(cuda):
    """At batch 1 43 of the 53 convs run split, each a single wave of one
    block an SM: the device holds their clusters at once, so the capture
    holds kernels launched in clusters; ``reset`` zeroes the count."""
    apply, params = cnn.resnet50_apply, _card_net("resnet50", torch.float32)
    (x, *_), _ = _card_inputs(torch.float32)
    cnn_graph.reset(apply)
    for _ in range(3):
        apply(params, x)
    torch.cuda.synchronize()
    clustered = apply.graph_cluster_kernels
    assert apply.graph_captures == 1
    assert clustered == apply.graph_entry.graph.cluster_kernels
    assert 0 < clustered <= CONVS["resnet50"]
    cnn_graph.reset(apply)
    assert apply.graph_cluster_kernels == 0


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pruned_replayed_logits_equal_eager_bits(cuda, dtype):
    """The pruned forward prunes once, captures on its second call and
    replays the bits of the eager forward of the pruned dict (the path
    that pruned on every call)."""
    apply, params = cnn.resnet50_apply, _card_net("resnet50", dtype)
    aligned, off = _card_inputs(dtype)
    pre = cnn.resnet50_prune(params, 0.5)[0]
    cnn_graph.reset(apply)
    answers = []
    for xs in (aligned, [off] * 3):
        want = [_eager(apply, pre, x) for x in xs]
        answers += zip([apply(params, x, keep_fractions=0.5) for x in xs],
                       want)
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for got, want in answers)
    assert (apply.graph_eager["new_key"], apply.graph_captures,
            apply.graph_replays) == (2, 2, 4)
    assert (apply.prunes, apply.prune_hits) == (1, 5)


@pytest.mark.chip
def test_a_pruned_weight_written_in_place_is_pruned_again_on_the_card(cuda):
    apply, params = cnn.resnet50_apply, _card_net("resnet50", torch.float32)
    (x, *_), _ = _card_inputs(torch.float32)
    cnn_graph.reset(apply)
    before = [apply(params, x, sparse=True) for _ in range(3)]
    params["conv3_b2"]["c2"].mul_(0.5)
    outs = [apply(params, x, sparse=True) for _ in range(3)]
    want = _eager(apply, cnn.resnet50_prune(params, 0.5)[0], x)
    torch.cuda.synchronize()
    assert (apply.prunes, apply.graph_captures) == (2, 2)
    assert all(torch.equal(o, want) for o in outs)
    assert not torch.equal(want, before[-1])
