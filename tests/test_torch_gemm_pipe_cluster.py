"""The split combine of the pipelined CNN kernel in thread block clusters
(``csrc/gemm_pipe.cuh``): where a split grid's clusters of a tile's S
splits are all resident at once and the grid does not crowd its SMs, the S
blocks add their partial sums through distributed shared memory, each
flushing its own share of the tile's rows, with no workspace or ticket.

On the CPU, the source holds the rules: a block reads its peers' shared
memory only between the cluster's two barriers; no block of a cluster
leaves before the second; the cluster path touches no workspace or
ticket; the peers are added in split order from 0; the ranks' row shares
cover every element of the tile once, ragged shares too; the dynamic
shared memory holds the tile's fp32 sums for both element types; the
launch takes clusters of S from the occupancy the runtime reports, and
none for a grid that would crowd its SMs.  On the card (``chip``, skipped
without one): for every tile code and route, S from 2 to 18 splits, fp32
and bf16, the output matches the plain version, launches back to back
(sharing the workspace with another plan) and replayed from a CUDA graph
give the bits of a lone launch, every grid of at most 16 splits runs in
clusters and one of 18 without, and every ticket is 0 afterwards.

    PYTHONPATH=src python -m pytest -q tests/test_torch_gemm_pipe_cluster.py
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core.autotune import TileConfig
from repro_torch.kernels import _build, ref
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import matmul as t_mm
from repro_torch.models import cnn_graph

CSRC = Path(_build.__file__).parent / "csrc"
PIPE = (CSRC / "gemm_pipe.cuh").read_text()
PTX = (CSRC / "ptx.cuh").read_text()


def _function(name: str, text: str = PIPE) -> str:
    """The body of the function ``name`` (from its first ``{``)."""
    start = text.index("{", text.index(name + "("))
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise AssertionError(f"{name}: no end")


def _code(text: str) -> str:
    return re.sub(r"//[^\n]*", "", text)


COMBINE = _code(_function("void cluster_combine"))
KERNEL = _code(_function("pipe_conv_kernel"))
ARRIVE, WAIT = "cluster_arrive();", "cluster_wait();"


def _block_after(text: str, head: str) -> str:
    """The braced block that follows ``head`` in ``text``."""
    start = text.index("{", text.index(head))
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise AssertionError(f"{head}: no end")


def test_the_cluster_helpers_are_the_ptx_they_name():
    for fn, ptx in (("cluster_size", "%%cluster_nctarank"),
                    ("cluster_rank", "%%cluster_ctarank"),
                    ("void cluster_arrive", "barrier.cluster.arrive.release"),
                    ("void cluster_wait", "barrier.cluster.wait.acquire"),
                    ("map_to_rank", "mapa.shared::cluster.u32"),
                    ("ld_cluster4", "ld.shared::cluster.v4.f32")):
        assert ptx in _function(fn, PTX), fn


def test_peers_are_read_only_between_the_two_barriers():
    """Barrier one (arrive, wait) follows the block's own sums into its
    shared memory; every read of a peer's lies after it and before the
    second barrier's arrive, whose wait is the function's last statement;
    nothing else in the file reads a peer."""
    assert COMBINE.count(ARRIVE) == 2 and COMBINE.count(WAIT) == 2
    first_arrive = COMBINE.index(ARRIVE)
    first_wait = COMBINE.index(WAIT)
    second_arrive = COMBINE.index(ARRIVE, first_arrive + 1)
    second_wait = COMBINE.index(WAIT, first_wait + 1)
    own = COMBINE.index("mine[(i * 2 + h) * P::TT + gt] =")
    assert own < first_arrive < first_wait < second_arrive < second_wait
    reads = [m.start() for m in re.finditer(r"ld_cluster4\(", COMBINE)]
    assert reads and all(first_wait < r < second_arrive for r in reads)
    assert COMBINE.rstrip()[:-1].rstrip().endswith(WAIT)
    assert _code(PIPE).count("ld_cluster4(") == len(reads)
    assert _code(PIPE).count("map_to_rank(") == COMBINE.count("map_to_rank(")


def test_no_block_leaves_before_the_second_barrier():
    """cluster_combine has no return of its own (its lambdas return
    values); the kernel returns right after it, and nothing between the
    trigger and the cluster branch leaves."""
    body = re.sub(r"\[&\]\([^)]*\)\s*\{[^{}]*\}", "", COMBINE)
    assert "return" not in body
    branch = _block_after(KERNEL, "if (CLUSTER)")
    assert re.fullmatch(r"\{\s*cluster_combine<T, P, VEC>\([^;]*\);\s*"
                        r"return;\s*\}", branch)
    trigger = KERNEL.index("grid_dependents_launch();")
    at = KERNEL.index("if (CLUSTER)")
    assert trigger < at
    assert "return" not in KERNEL[trigger:at]


def test_the_cluster_path_touches_no_workspace_or_ticket():
    """cluster_combine is handed neither, fences nothing and takes no
    ticket; the kernel branches to it before the ticket path."""
    head = PIPE[PIPE.index("void cluster_combine("):]
    params = head[:head.index(")")]
    assert "ws" not in params and "tickets" not in params
    for name in ("__stcg", "__ldcg", "atomicAdd", "__threadfence", "ws",
                 "tickets", "last"):
        assert not re.search(rf"\b{name}\b", COMBINE), name
    assert (KERNEL.index("if (CLUSTER)")
            < KERNEL.index("if (gridDim.z > 1)"))


def test_peers_are_added_in_split_order_from_zero():
    """Rank z of a cluster is split z (the clusters run along the grid's
    z, one tile's S splits); every peer's float4 is loaded before the
    adds, and peer z's is the z-th term, after 0 (the order of the last
    block on the ticket path)."""
    assert re.search(
        r"float4 p\[CLUSTER_MAX\];\s*#pragma unroll\s*"
        r"for \(int z = 0; z < CLUSTER_MAX; \+\+z\)\s*"
        r"if \(z < cs\) p\[z\] = ld_cluster4\(map_to_rank\(addr, z\)\);\s*"
        r"float v\[4\] = \{0.f, 0.f, 0.f, 0.f\};\s*#pragma unroll\s*"
        r"for \(int z = 0; z < CLUSTER_MAX; \+\+z\)\s*if \(z < cs\) \{\s*"
        r"v\[0\] \+= p\[z\].x; v\[1\] \+= p\[z\].y; v\[2\] \+= p\[z\].z; "
        r"v\[3\] \+= p\[z\].w;\s*\}", COMBINE)
    dim = _code(_function("cudaLaunchAttribute cluster_dim"))
    assert "a.val.clusterDim.x = 1;" in dim
    assert "a.val.clusterDim.y = 1;" in dim
    assert "a.val.clusterDim.z = cs;" in dim
    # the ticket path's order: 0, then split 0, 1, ...
    ticket = KERNEL[KERNEL.index("if (gridDim.z > 1)"):]
    assert "sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);" in ticket
    assert "for (int z0 = 0; z0 < n_split; z0 += P::G)" in ticket


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", PIPE).group(1))


def _pipe_struct(bm: int, bn: int, g: int) -> dict:
    """The constants of ``Pipe<bm, bn, g>`` as the header defines them."""
    tt = (bm // 8) * (bn // 8)
    stage = bm * _constant("PIPE_BK") + _constant("PIPE_BK") * bn
    return {"BM": bm, "BN": bn, "G": g, "TT": tt, "THREADS": g * tt,
            "TX": bn // 8, "ROWSTEP": bm // 8, "SLOT": g * stage}


def _c_expr(expr: str, env: dict) -> int:
    """A C integer expression over ``P::`` constants and locals, as
    Python (integer division; every operand here is non-negative)."""
    expr = re.sub(r"P::(\w+)", lambda m: str(env[m.group(1)]), expr)
    expr = re.sub(r"\(size_t\)", "", expr)
    expr = expr.replace("sizeof(float)", "4").replace("sizeof(T)", "T")
    return eval(" ".join(expr.replace("/", "//").split()), {}, env)


@pytest.mark.parametrize("t_bytes", [4, 2])
@pytest.mark.parametrize("tile", range(len(_build.PIPE_TILES)))
def test_the_shared_memory_holds_the_tiles_fp32_sums(tile, t_bytes):
    """pipe_ring_bytes, which puts the row table after it and sizes every
    launch, is at least BM x BN fp32 values, for fp32 and bf16 rings; the
    sums are written from the start of the dynamic shared memory."""
    body = _code(_function("size_t pipe_ring_bytes"))
    env = {**_pipe_struct(*_build.PIPE_TILES[tile]), "T": t_bytes,
           "PIPE_STAGES": _constant("PIPE_STAGES")}
    ring = _c_expr(re.search(r"ring = ([^;]*);", body).group(1), env)
    sums = _c_expr(re.search(r"sums = ([^;]*);", body).group(1), env)
    assert "return ring > sums ? ring : sums;" in body
    bm, bn, _ = _build.PIPE_TILES[tile]
    assert max(ring, sums) >= bm * bn * 4
    assert "float4* mine = reinterpret_cast<float4*>(smem);" in COMBINE
    assert ("Row* rows = reinterpret_cast<Row*>(smem + pipe_ring_bytes<P, "
            "T>());") in KERNEL
    smem = _code(_function("size_t pipe_smem_bytes"))
    assert "pipe_ring_bytes<P, T>()" in smem


def _at(tile: int):
    """cluster_combine's row share of a rank, and element -> (row, float4
    column, shared-memory float4)."""
    env = _pipe_struct(*_build.PIPE_TILES[tile])
    env["V4"] = env["BN"] // 4
    lo_hi = re.search(r"const int lo = ([^,]*), hi = ([^;]*);", COMBINE)
    row_q = re.search(r"const int row = ([^,]*), q = ([^;]*);", COMBINE)
    at = re.search(r"smem_addr\(\s*mine \+ ([^;]*)\);", COMBINE)

    def share(rank, cs):
        e = {**env, "rank": rank, "cs": cs}
        return _c_expr(lo_hi.group(1), e), _c_expr(lo_hi.group(2), e)

    def slot(lo, e):
        env2 = {**env, "lo": lo, "e": e}
        env2["row"] = _c_expr(row_q.group(1), env2)
        env2["q"] = _c_expr(row_q.group(2), env2)
        return env2["row"], env2["q"], _c_expr(at.group(1), env2)
    return env, share, slot


@pytest.mark.parametrize("cs", range(2, 17))
@pytest.mark.parametrize("tile", range(len(_build.PIPE_TILES)))
def test_the_row_shares_cover_the_tile_once(tile, cs):
    """Ranks 0..cs-1 own disjoint row ranges that cover the tile (ragged
    where cs does not divide BM), and each element maps to the float4
    where the block's own write put that row's columns."""
    env, share, slot = _at(tile)
    written = {}
    for i in range(8):
        for h in range(2):
            for gt in range(env["TT"]):
                ty, tx = gt // env["TX"], gt % env["TX"]
                written[(i * 2 + h) * env["TT"] + gt] = (
                    ty + i * env["ROWSTEP"], h * env["BN"] // 2 + tx * 4)
    seen = {}
    bounds = [share(r, cs) for r in range(cs)]
    assert bounds[0][0] == 0 and bounds[-1][1] == env["BM"]
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for lo, hi in bounds:
        assert hi - lo in (env["BM"] // cs, -(-env["BM"] // cs))
        for e in range((hi - lo) * env["V4"]):
            row, q, at = slot(lo, e)
            assert written[at] == (row, q * 4), (lo, e)
            seen[at] = seen.get(at, 0) + 1
    assert seen == dict.fromkeys(written, 1)


def test_the_launch_takes_clusters_of_s_from_the_occupancy():
    """Clusters of all S splits of a tile, S at most CLUSTER_MAX, where the
    device holds every cluster of the grid at once; sizes above the
    portable 8 allowed at every such launch; the occupancy asked once per
    device, shared memory size and S."""
    rule = _code(_function("cudaError_t cluster_size_for"))
    assert ("if (splits == 1 || splits > CLUSTER_MAX) return cudaSuccess;"
            in rule)
    assert "cudaOccupancyMaxActiveClusters(&held, kernel, &q)" in rule
    assert "cudaLaunchAttribute dim = cluster_dim(splits);" in rule
    assert re.search(r"if \(err == cudaSuccess && splits > CLUSTER_PORTABLE\)"
                     r"\s*err = cudaFuncSetAttribute\(\s*kernel, "
                     r"cudaFuncAttributeNonPortableClusterSizeAllowed, 1\);",
                     rule)
    assert re.search(r"if \(bytes > 48 \* 1024\)\s*err = cudaFuncSetAttribute"
                     r"\(\s*kernel, "
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize",
                     rule)
    assert ("SmRoom* slot = dev < SM_ROOM_DEVICES ? &cache[dev][splits]"
            in rule)
    assert "if (word == 0 || word >> 32 != bytes)" in rule
    assert ("if ((int64_t)(word & 0xffffffff) - 1 >= blocks / splits) "
            "cs = splits;") in rule
    assert (_constant("CLUSTER_PORTABLE"), _constant("CLUSTER_MAX")) == (8, 16)
    launch = _code(_function("int pipe_launch_tile"))
    assert ("static SmRoom clusters[SM_ROOM_DEVICES][CLUSTER_MAX + 1];"
            in launch)
    # the cluster combine is an instance of its own, launched only in
    # clusters: the other instance holds none of its code
    assert "auto kernel = pipe_conv_kernel<T, P, VEC, false>;" in launch
    assert "auto clustered = pipe_conv_kernel<T, P, VEC, true>;" in launch
    assert "cluster_size_for(clustered, cfg, room, clusters, cs)" in launch
    assert "if (cs > 1) attrs[cfg.numAttrs++] = cluster_dim(cs);" in launch
    assert "&cfg, cs > 1 ? clustered : kernel," in launch
    assert "template <typename T, class P, bool VEC, bool CLUSTER>" in PIPE
    assert KERNEL.count("CLUSTER") == 1


# (grid blocks, blocks an SM holds, clusters allowed) on a card of 132
# SMs, as timed on the H100: ResNet-50's single-wave grids of one block an
# SM and its 56x56 3x3 (392 blocks of six an SM) gained in clusters;
# VGG-16's 112x112 and 28x28 3x3s (392 of three an SM, 520 of six) lost.
CROWDING = [(128, 1, True), (130, 1, True), (98, 6, True), (392, 6, True),
            (392, 3, False), (520, 6, False), (784, 6, False), (133, 1, False)]


@pytest.mark.parametrize("blocks,per_sm,allowed", CROWDING)
def test_a_grid_that_would_crowd_its_sms_runs_without_clusters(
        blocks, per_sm, allowed):
    """More blocks an SM, spread evenly, than one and than half what an SM
    holds: no clusters (read from fills_every_sm's cache for this shared
    memory size)."""
    rule = _code(_function("cudaError_t cluster_size_for"))
    cond = re.search(r"if \(room >> 32 != bytes \|\| sms == 0 \|\|\s*"
                     r"(blocks > [^;]*)\)\s*return cudaSuccess;", rule)
    assert cond
    assert ("rooms[dev].load(std::memory_order_relaxed)" in rule
            and "sms = room & 0xffff, per_sm = room >> 16 & 0xffff" in rule)
    crowded = eval(cond.group(1).replace("std::max<int64_t>", "max")
                   .replace("/", "//"),
                   {"max": max}, {"blocks": blocks, "sms": 132,
                                  "per_sm": per_sm})
    assert (not crowded) == allowed


# ----------------------------------------------------------- on the card ---
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SPLITS = [2, 4, 5, 8, 9, 15, 16, 18]
ROUTES = ["conv2d", "mm_act_stationary", "mm_weight_stationary"]
R = 4608                  # a 3x3 over 512 channels: every S above is whole
REPEATS = 8
SLEEP_CYCLES = 2_000_000  # about 1 ms: the host enqueues ahead


def _operands(route: str, dtype, seed: int, c: int = 512):
    """A layer small enough that a split grid's clusters are all resident
    (2 to 4 tiles, at most 72 blocks): 49 or 100 rows (ragged in 64-row
    tiles), 96 columns (the second 64-column tile half used), with every
    part of the flush."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    k = 96
    if route == "conv2d":
        x, w = draw(1, 7, 7, c), draw(3, 3, c, k, scale=(9 * c) ** -0.5)
        out_shape = (1, 7, 7, k)
    else:
        m = 100 if route == "mm_act_stationary" else 49
        x, w = draw(m, 9 * c), draw(9 * c, k, scale=(9 * c) ** -0.5)
        out_shape = (m, k)
    ep = {"scale": torch.rand(k, generator=gen, device="cuda") + 0.5,
          "bias": torch.randn(k, generator=gen, device="cuda"),
          "residual": draw(*out_shape), "relu": True}
    return x, w, ep


def _run(route: str, x, w, ep, tile: int, splits: int):
    tiles = TileConfig(tile, splits)
    if route == "conv2d":
        return t_conv.conv2d(x, w, padding=1, tiles=tiles, **ep)
    if route == "mm_act_stationary":
        return t_mm.matmul_act_stationary(x, w, tiles=tiles, **ep)
    return t_mm.matmul_weight_stationary(x, w, tiles=tiles, **ep)


def _plain(route: str, x, w, ep):
    if route == "conv2d":
        return ref.conv2d_ref(x, w, 1, 1, **ep)
    return ref.matmul_ref(x, w, **ep)


def _tol(want: torch.Tensor, dtype, reduction: int) -> float:
    """The checks' tolerance (chip_smoke.py, phase 4): fp32 2e-4 x sqrt(R);
    bf16 max(2e-2 x sqrt(R), 2^-7 x max|plain|)."""
    if dtype != torch.bfloat16:
        return 2e-4 * reduction ** 0.5
    return max(2e-2 * reduction ** 0.5, 2.0 ** -7 * want.abs().max().item())


def _check_case(x, w, ep, route, tile, splits, dtype, other: int):
    """The lone launch against the plain version; REPEATS launches
    enqueued ahead, each after a launch of ``other`` splits that shares
    the workspace and tickets; a graph of the pair, replayed; tickets 0."""
    torch.cuda.synchronize()
    want = _run(route, x, w, ep, tile, splits)
    torch.cuda.synchronize()
    plain = _plain(route, x, w, ep)
    err = (want.float() - plain).abs().max().item()
    assert err <= _tol(plain, dtype, x.shape[-1] * (9 if route == "conv2d"
                                                    else 1)), err
    assert not _build._tickets[x.device].any()
    torch.cuda._sleep(SLEEP_CYCLES)
    ahead = [(_run(route, x, w, ep, tile, other),
              _run(route, x, w, ep, tile, splits)) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    assert not _build._tickets[x.device].any()
    assert all(torch.equal(b, want) for _, b in ahead)
    assert all(torch.equal(a, ahead[0][0]) for a, _ in ahead)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        a, b = (_run(route, x, w, ep, tile, other),
                _run(route, x, w, ep, tile, splits))
    graph.instantiate()
    got = []
    for _ in range(REPEATS):
        graph.replay()
        got.append((a.clone(), b.clone()))
    torch.cuda.synchronize()
    assert all(torch.equal(gb, want) and torch.equal(ga, ahead[0][0])
               for ga, gb in got)
    assert not _build._tickets[x.device].any()


def _clustered(route, x, w, ep, tile, splits) -> int:
    """The kernels in clusters of a graph of the one launch."""
    _run(route, x, w, ep, tile, splits)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        _run(route, x, w, ep, tile, splits)
    return cnn_graph.cluster_kernels(graph.raw_cuda_graph())


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("tile", [0, 1, 2])
def test_the_cluster_combine_matches_the_plain_version(cuda, tile, route,
                                                       splits, dtype):
    x, w, ep = _operands(route, dtype, seed=tile * 100 + splits)
    # at most 72 blocks: every grid of up to 16 splits in clusters
    assert _clustered(route, x, w, ep, tile, splits) == (splits <= 16)
    _check_case(x, w, ep, route, tile, splits, dtype,
                other=2 if splits != 2 else 18)


@pytest.mark.chip
@pytest.mark.parametrize("splits", [4, 9, 16])
def test_the_general_path_in_clusters(cuda, splits):
    """C = 509: the element gather and the flush of any N; the index
    table of a split holds at most 2048 indices, so S >= 3."""
    x, w, ep = _operands("conv2d", torch.float32, seed=splits, c=509)
    assert not _build.vec_path(509, 96, x, w, ep["residual"])
    assert _clustered("conv2d", x, w, ep, 2, splits) == 1
    _check_case(x, w, ep, "conv2d", 2, splits, torch.float32, other=3)
