"""The pipelined CNN kernel as a programmatic dependent launch
(``csrc/gemm_pipe.cuh``): a launch of ``pipe_conv_kernel`` may be placed
while the kernel before it on the stream finishes, and waits in
``griddepcontrol.wait`` before it touches anything that kernel writes.

On the CPU, the source holds the rule: before the wait a block builds its
tables and asks the L2 for weight lines, and reads nothing from device
memory; every block reaches the wait; the trigger follows the main loop and
precedes the split combine; a launch carries the attribute where a normal
launch would fill every SM.  On the card (``chip``, skipped without one):
two launches back to back that share the split workspace and the ticket
counters, the second reading the first's output as its input, or as its
weights (``matmul(x, matmul(a, b))``, and a conv whose filter the GEMM
before it wrote), give the bits of the same two launches with a
synchronise between them, enqueued ahead of the device and replayed from a
CUDA graph, 20 times each, for every tile code.

    PYTHONPATH=src python -m pytest -q tests/test_torch_gemm_pipe_pdl.py
"""
import contextlib
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core.autotune import TileConfig
from repro_torch.kernels import _build
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import matmul as t_mm
from repro_torch.models import cnn_graph

PIPE = (Path(_build.__file__).parent / "csrc" / "gemm_pipe.cuh").read_text()


def _function(name: str) -> str:
    """The body of the function ``name`` (from its first ``{``)."""
    start = PIPE.index("{", PIPE.index(name + "("))
    depth = 0
    for i in range(start, len(PIPE)):
        depth += {"{": 1, "}": -1}.get(PIPE[i], 0)
        if depth == 0:
            return PIPE[start:i + 1]
    raise AssertionError(f"{name}: no end")


KERNEL = _function("pipe_conv_kernel")
WAIT = "grid_dependency_wait();"
TRIGGER = "grid_dependents_launch();"


def _calls(code: str) -> set:
    """Names called in ``code`` (templates' arguments dropped)."""
    code = re.sub(r"//[^\n]*", "", code)
    return set(re.findall(r"([A-Za-z_][\w.:]*)\s*(?:<[^;(){}]*>)?\s*\(",
                          code)) - {"if", "for", "while", "return"}


def test_the_kernel_waits_once():
    assert KERNEL.count(WAIT) == 1 and KERNEL.count(TRIGGER) == 1


def test_before_the_wait_only_tables_and_l2_prefetches():
    """Rows and index tables (the loader's constructor), the weights' L2
    prefetch, and arithmetic on constants: no copy, no load, no store to
    device memory."""
    before = KERNEL[:KERNEL.index(WAIT)]
    assert _calls(before) <= {
        "build_rows", "ld", "prefetch_weights", "min", "ceil_div",
        "reinterpret_cast", "pipe_ring_bytes", "__align__"}
    for name in ("x", "res", "out", "ws", "tickets", "ep"):
        uses = re.findall(rf"(?<![\w.]){name}\b", before)
        assert len(uses) == (name == "x"), name      # Loader ld(x, ...)
    assert not re.search(r"(?<![\w.])w\s*\[", before)
    assert not re.search(r"return\s*;", before)
    assert "__syncthreads" not in before


def test_the_weight_prefetch_loads_nothing():
    """The helper only computes line addresses and hands them to
    ``prefetch.global.L2``."""
    helper = _function("void prefetch_weights")
    assert _calls(helper) <= {"min", "reinterpret_cast", "sizeof",
                              "prefetch_l2"}
    code = re.sub(r"//[^\n]*", "", helper)
    assert not re.search(r"\b(w|row)\s*\[", code)          # no w[i]
    assert not re.search(r"(?:^|[^\w\s])\s*\*\s*(w|row)\b", code)  # no *w
    ptx = (Path(_build.__file__).parent / "csrc" / "ptx.cuh").read_text()
    body = ptx[ptx.index("void prefetch_l2("):]
    assert body[:body.index("}")].count("prefetch.global.L2 [%0]") == 1


def test_the_loaders_constructors_read_no_operand():
    """Both loaders' constructors keep the pointers; the general one
    writes its index table from the shape alone."""
    for loader in ("VecLoader", "ElemLoader"):
        ctor = _function(f"__device__ {loader}")
        assert not re.search(r"\b[xw]\s*\[|\*\s*[xw]\b", ctor), loader


def test_the_trigger_follows_the_main_loop():
    """After every slot is multiplied, before the groups' sums, the split
    combine and the store."""
    at = KERNEL.index(TRIGGER)
    loop_end = KERNEL.index("cp_async_wait<0>();")
    assert loop_end < at
    for later in ("if (P::G > 1)", "atomicAdd", "__stcg", "flush_store4"):
        assert at < KERNEL.index(later), later
    assert not re.search(r"return\s*;", KERNEL[:at])


def test_launches_are_programmatic_where_they_fill_every_sm():
    """One launch call, carrying the attribute exactly where a normal
    launch would fill every SM to the kernel's occupancy."""
    launch = _function("int pipe_launch_tile")
    assert "<<<" not in launch and PIPE.count("cudaLaunchKernelEx(") == 1
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in launch
    assert "programmaticStreamSerializationAllowed = 1" in launch
    assert "fills_every_sm(kernel, cfg, room, early)" in launch
    assert "static SmRoom room[SM_ROOM_DEVICES];" in launch
    assert "cfg.numAttrs = early ? 1 : 0;" in launch
    rule = _function("cudaError_t fills_every_sm")
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in rule
    assert "(blocks + sms - 1) / sms >= room" in rule
    # asked of the runtime only when the device's cached word is for
    # another shared memory size (or not there yet)
    assert "if (word == 0 || word >> 32 != bytes)" in rule


# ----------------------------------------------------------- on the card ---
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


REPEATS = 20
SLEEP_CYCLES = 2_000_000       # about 1 ms: the host enqueues ahead
# Routes: the second launch reads the first's output as its input (and,
# for conv2d, its residual), or as its weights.
ROUTES = ["conv2d", "mm_act_stationary", "matmul_weights", "conv2d_weights"]


def _pair(tile: int, route: str, batch: int = 4):
    """Two split launches, the second (tile code ``tile``) reading the
    first's output, and the tensor ``src`` the first reads.  At batch 4
    (12,544 rows), and at 32,768 rows for ``matmul_weights``, every second
    launch fills each SM to its occupancy, so it is programmatic; at batch
    1 a 64x64 tile's is not.  The weight routes' first launch is a GEMM of
    four splits (tile code 2) whose (C, K) output is the weight matrix of
    ``matmul(x, .)``, or a 3x3 filter of 64 channels in and out.  Each
    repeat writes new values to ``src``, so a read of the first's output
    before it is stored would see another repeat's bits."""
    gen = torch.Generator(device="cuda").manual_seed(tile)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    second = TileConfig(tile, 4)
    if route.endswith("_weights"):
        src = draw(1024, 64 if route == "conv2d_weights" else 128,
                   scale=0.03)
        a = draw(576 if route == "conv2d_weights" else 256, 1024)
        if route == "conv2d_weights":
            x = draw(batch, 56, 56, 64)

            def run():
                w = t_mm.matmul(a, src, tiles=TileConfig(2, 4))
                return w, t_conv.conv2d(x, w.view(3, 3, 64, 64), padding=1,
                                        relu=True, tiles=second)
        else:
            x = draw(32768, 256)

            def run():
                w = t_mm.matmul(a, src, tiles=TileConfig(2, 4))
                return w, t_mm.matmul(x, w, tiles=TileConfig(tile, 2))
    else:
        src = draw(batch, 56, 56, 64)
        w1 = draw(3, 3, 64, 64, scale=0.05)
        w2 = draw(3, 3, 64, 64, scale=0.05)
        w2_mm = draw(64, 96, scale=0.1)
        scale = torch.rand(64, generator=gen, device="cuda") + 0.5

        def run():
            y = t_conv.conv2d(src, w1, padding=1, relu=True,
                              tiles=TileConfig(2, 6))
            if route == "conv2d":
                return y, t_conv.conv2d(y, w2, padding=1, scale=scale,
                                        residual=y, relu=True, tiles=second)
            return y, t_mm.matmul_act_stationary(y, w2_mm, tiles=second)
    drawn = [draw(*src.shape, scale=float(src.std())) for _ in range(REPEATS)]
    return src, drawn, run


def _apart(src, drawn, run):
    """Each repeat's two launches with a synchronise after each."""
    want = []
    for d in drawn:
        src.copy_(d)
        torch.cuda.synchronize()
        want.append(_synchronised(run))
    return want


def _synchronised(run):
    """``run``'s launches with a synchronise between the two."""
    done = []
    with _sync_after_each_launch(done):
        y, z = run()
    torch.cuda.synchronize()
    assert done == [1, 2], done
    return y, z


@contextlib.contextmanager
def _sync_after_each_launch(done):
    """``_build.launch`` followed by a synchronise, counting launches."""
    launch = _build.launch

    def launch_then_sync(*args, **kw):
        out = launch(*args, **kw)
        torch.cuda.synchronize()
        done.append(len(done) + 1)
        return out
    _build.launch = launch_then_sync
    try:
        yield
    finally:
        _build.launch = launch


@pytest.mark.chip
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("tile", [0, 1, 2])
def test_back_to_back_split_launches_equal_synchronised_ones(cuda, tile,
                                                             route):
    src, drawn, run = _pair(tile, route)
    _synchronised(run)                  # grows the shared scratch first
    ws = _build._partials[src.device].data_ptr()
    want = _apart(src, drawn, run)
    got = []
    for d in drawn:
        torch.cuda._sleep(SLEEP_CYCLES)
        src.copy_(d)
        got.append(run())
    torch.cuda.synchronize()
    assert _build._partials[src.device].data_ptr() == ws
    assert [i for i, ((y, z), (wy, wz)) in enumerate(zip(got, want))
            if not (torch.equal(y, wy) and torch.equal(z, wz))] == []


@pytest.mark.chip
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("tile", [0, 1, 2])
def test_replayed_split_launches_equal_synchronised_ones(cuda, tile, route):
    """The pair captured as one graph holds a programmatic edge between
    them and replays the synchronised launches' bits, ``src`` written
    anew before each replay."""
    src, drawn, run = _pair(tile, route)
    _synchronised(run)
    want = _apart(src, drawn, run)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        y, z = run()
    assert cnn_graph.programmatic_edges(graph.raw_cuda_graph()) >= 1
    graph.instantiate()
    got = []
    for d in drawn:
        src.copy_(d)
        graph.replay()
        got.append((y.clone(), z.clone()))
    torch.cuda.synchronize()
    assert [i for i, ((a, b), (wy, wz)) in enumerate(zip(got, want))
            if not (torch.equal(a, wy) and torch.equal(b, wz))] == []


@pytest.mark.chip
def test_a_thin_grid_is_not_placed_early(cuda):
    """The 64x64 tile at 3,136 rows in 4 splits: 196 blocks where an SM
    holds several, so the launch is a normal one and the pair's graph has
    no programmatic edge."""
    src, drawn, run = _pair(1, "conv2d", batch=1)
    src.copy_(drawn[0])
    want = _synchronised(run)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        y, z = run()
    assert cnn_graph.programmatic_edges(graph.raw_cuda_graph()) == 0
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want[0]) and torch.equal(z, want[1])
