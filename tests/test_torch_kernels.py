"""Port parity: the kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` takes its plain PyTorch
version (a CUDA kernel has no interpret mode; ``chip_smoke.py`` holds the
kernels themselves to these plain versions on the card).  Here those CPU
paths are held to ``repro``'s Pallas kernels run with ``interpret=True`` on
the same numpy inputs, over the shape lists of ``tests/test_kernels.py``,
fp32 and bf16, at its tolerance ``_tol`` (2e-4 / 2e-2 x scale).  Each case
gets one epilogue combination, rotating so that every part (scale, bias,
residual, ReLU) is both on and off across each sweep.

The rest checks what the card run relies on and the CPU can see: the
Python tile constants and ctypes signatures against the CUDA sources, the
planners, engine resolution and the launch counters.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import CONV_CASES, MM_CASES, _tol

from repro.kernels import conv2d as j_conv2d
from repro.kernels import matmul_act_stationary as j_mm_as
from repro.kernels import matmul_weight_stationary as j_mm_ws
from repro_torch.core import autotune
from repro_torch.core.autotune import AS, WS
from repro_torch.core.fuse import Epilogue
from repro_torch.kernels import _build, ops
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import matmul as t_mm

EPILOGUES = [(), ("scale",), ("bias",), ("residual",), ("relu",),
             ("scale", "bias", "relu"), ("scale", "bias", "residual", "relu")]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _params(cases):
    """(case, dtype name, epilogue parts), the epilogue rotating."""
    out = []
    for i, case in enumerate(cases):
        for j, name in enumerate(DTYPES):
            out.append((case, name, EPILOGUES[(2 * i + j) % len(EPILOGUES)]))
    return out


def _operands(rng, x_shape, w_shape, out_shape, parts):
    """numpy inputs (fp32) and the epilogue operands the parts ask for."""
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32)
    k = w_shape[-1]
    ep = {"scale": (1.0 + 0.2 * rng.standard_normal(k)).astype(np.float32),
          "bias": (0.3 * rng.standard_normal(k)).astype(np.float32),
          "residual": rng.standard_normal(out_shape).astype(np.float32)}
    ep = {n: v for n, v in ep.items() if n in parts}
    return x, w, ep


def _both(x, w, ep, dtype_name, relu):
    jd, td = DTYPES[dtype_name]
    j_kw = {n: jnp.asarray(v, jd if n == "residual" else jnp.float32)
            for n, v in ep.items()}
    t_kw = {n: torch.from_numpy(v).to(td if n == "residual" else
                                      torch.float32) for n, v in ep.items()}
    return ((jnp.asarray(x, jd), jnp.asarray(w, jd), dict(j_kw, relu=relu)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
             dict(t_kw, relu=relu)))


def _err(got_t, want_j) -> float:
    return float(np.max(np.abs(got_t.float().numpy()
                               - np.asarray(want_j, np.float32))))


@pytest.mark.parametrize("case,dtype,parts", _params(CONV_CASES))
def test_conv2d_matches_pallas(case, dtype, parts):
    b, h, w, c, k, fl, s, p = case
    oh = (h - fl + 2 * p) // s + 1
    ow = (w - fl + 2 * p) // s + 1
    rng = np.random.default_rng(b * 100 + h + c + fl)
    x, wt, ep = _operands(rng, (b, h, w, c), (fl, fl, c, k), (b, oh, ow, k),
                          parts)
    (jx, jw, jkw), (tx, tw, tkw) = _both(x, wt, ep, dtype, "relu" in parts)
    want = j_conv2d(jx, jw, stride=s, padding=p, interpret=True, **jkw)
    got = t_conv.conv2d(tx, tw, stride=s, padding=p, **tkw)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    assert _err(got, want) < _tol(DTYPES[dtype][0], scale=fl * fl * c ** 0.5)


@pytest.mark.parametrize("case,dtype,parts", _params(MM_CASES))
@pytest.mark.parametrize("stationarity", ["act", "weight"])
def test_matmul_matches_pallas(case, dtype, parts, stationarity):
    m, c, k = case
    rng = np.random.default_rng(m + c + k)
    x, wt, ep = _operands(rng, (m, c), (c, k), (m, k), parts)
    (jx, jw, jkw), (tx, tw, tkw) = _both(x, wt, ep, dtype, "relu" in parts)
    j_fn, t_fn = ((j_mm_as, t_mm.matmul_act_stationary)
                  if stationarity == "act"
                  else (j_mm_ws, t_mm.matmul_weight_stationary))
    want = j_fn(jx, jw, **jkw)
    got = t_fn(tx, tw, **tkw)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    assert _err(got, want) < _tol(DTYPES[dtype][0], scale=c ** 0.5)


@pytest.mark.parametrize("stride", [1, 2])
def test_strided_nhwc_rows_match_the_subsampled_gemm(stride):
    """The 4-D form reads x[:, ::s, ::s] as rows (what the kernels fold)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    got = t_mm.matmul(x, w, stride=stride)
    sub = x[:, ::stride, ::stride].reshape(-1, 6)
    assert tuple(got.shape) == (2, -(-7 // stride), -(-9 // stride), 5)
    assert t_mm.gemm_rows(x, stride) == sub.shape[0]
    torch.testing.assert_close(got.reshape(-1, 5), sub @ w, rtol=1e-5,
                               atol=1e-5)


def test_cpu_path_counts_no_launch():
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    before = (t_conv.conv2d.launches, t_mm.matmul_act_stationary.launches,
              t_mm.matmul_weight_stationary.launches)
    t_mm.matmul_act_stationary(x, w)
    t_mm.matmul_weight_stationary(x, w)
    t_conv.conv2d(torch.randn(1, 5, 5, 2), torch.randn(3, 3, 2, 4), padding=1)
    assert before == (t_conv.conv2d.launches,
                      t_mm.matmul_act_stationary.launches,
                      t_mm.matmul_weight_stationary.launches)


# --------------------------- the CUDA sources -------------------------------
CSRC = Path(_build.__file__).parent / "csrc"


def test_python_tile_constants_match_the_sources():
    """conv2d and both 1x1 GEMMs: the tiles and constants of gemm_pipe.cuh
    (PIPE_TILES by tile code); matmul.cu defines no tile of its own."""
    pipe = (CSRC / "gemm_pipe.cuh").read_text()
    tiles = dict(re.findall(r"using Pipe(\w) = Pipe<(\d+, \d+, \d+)>;",
                            pipe))
    codes = re.findall(r"case (\d): return pipe_launch_tile<T, Pipe(\w)",
                       pipe)
    assert [int(c) for c, _ in codes] == list(range(len(_build.PIPE_TILES)))
    assert [tuple(int(v) for v in tiles[n].split(",")) for _, n in codes] \
        == list(_build.PIPE_TILES)
    consts = dict(re.findall(r"constexpr int (PIPE_\w+) = (\d+);", pipe))
    assert {k: int(v) for k, v in consts.items()} == {
        "PIPE_BK": _build.PIPE_BK, "PIPE_STAGES": _build.PIPE_STAGES,
        "PIPE_TABLE_MAX": _build.PIPE_TABLE_MAX}
    for src in ("conv2d.cu", "matmul.cu"):
        text = (CSRC / src).read_text()
        assert '#include "gemm_pipe.cuh"' in text
        assert not re.search(r"Tile<|__global__", text)


def _c_signatures(source: str) -> dict:
    text = (CSRC / source).read_text()
    sigs = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for a in args.split(","):
            a = a.strip()
            kinds.append("p" if "*" in a else "i")
            assert "*" in a or a.startswith("int "), a
        sigs[name] = kinds
    return sigs


@pytest.mark.parametrize("module,source", [(t_conv, "conv2d.cu"),
                                           (t_mm, "matmul.cu")])
def test_ctypes_signatures_match_the_c_entry_points(module, source):
    """ctypes must declare every pointer (and the stream) as c_void_p."""
    import ctypes
    c_sigs = _c_signatures(source)
    assert set(c_sigs) == set(module._SIGNATURES)
    for name, argtypes in module._SIGNATURES.items():
        kinds = ["p" if t is ctypes.c_void_p else "i" for t in argtypes]
        assert kinds == c_sigs[name], name


def test_build_hash_covers_every_source():
    names = {p.name for p in CSRC.iterdir()}
    assert {"conv2d.cu", "matmul.cu", "gemm_pipe.cuh", "numeric.cuh",
            "ptx.cuh"} <= names
    assert "tile_gemm.cuh" not in names
    assert [p.name for p in _build.sources()] == [
        "conv1d.cu", "conv2d.cu", "decode_attention.cu", "flash_attention.cu",
        "matmul.cu"]
    assert len(_build.source_hash()) == 16
    gitignore = (Path(__file__).parents[1] / ".gitignore").read_text()
    assert "src/repro_torch/kernels/_build/" in gitignore.split()


def test_tile_util_counts_padding():
    # 64 pixels x 64 channels: the 64x64 tile, nothing padded
    assert autotune.tile_util_conv2d((1, 8, 8, 16), (3, 3, 16, 64),
                                     1, 1) == 1.0
    # the stem's R = 147 pads to 160 (10 chunks of 16)
    m = 112 * 112
    plan = _build.plan_gemm(m, 64, 147, 132, False)
    assert autotune.tile_util_conv2d((1, 224, 224, 3), (7, 7, 3, 64),
                                     2, 3) == (
        m * 64 * 147 / (-(-m // plan.bm) * plan.bm * 64 * 160))
    # act-stationary pads M and K to its plan's tile, C to whole chunks
    for m, c, k in ((64, 32, 64), (64, 64, 32), (300, 97, 40)):
        p = _build.plan_gemm(m, k, c, 132, c % 16 == 0)
        want = m * c * k / (-(-m // p.bm) * p.bm * -(-k // p.bn) * p.bn
                            * -(-c // 16) * 16)
        assert autotune.tile_util_gemm(m, c, k, stationarity=AS) == want
    assert autotune.tile_util_gemm(64, 32, 64, stationarity=AS) == 1.0
    assert autotune.tile_util_gemm(128, 64, 64, stationarity=AS) == 1.0
    # weight-stationary pads M to its one row tile, K to the plan's columns
    assert autotune.tile_util_gemm(49, 512, 2048, stationarity=WS) == 49 / 64
    p = _build.plan_weight_stationary(100, 32, 16, 132, True)
    assert (p.bm, p.bn) == (128, 64)
    assert autotune.tile_util_gemm(100, 16, 32, stationarity=WS) == (
        100 * 32 / (128 * 64))


# (M, N, R) of main-path layers at batch 1 and ragged ones
GEMMS = [(12544, 64, 147), (3136, 64, 576), (784, 128, 1152),
         (196, 256, 2304), (49, 512, 4608), (50176, 64, 27),
         (50176, 64, 576), (12544, 128, 1152), (196, 512, 4608),
         (3136, 256, 64), (196, 1024, 256), (300, 40, 64), (1, 5, 17),
         (513, 257, 129), (64, 67, 1179), (7, 9, 40000), (1, 1, 1)]


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("m,n,r", GEMMS)
def test_pipe_plan_covers_the_reduction(m, n, r, vec):
    """Every index of R in exactly one split, whole chunks, at least
    MIN_CHUNKS_PER_SPLIT of them when split, and on the general path a split
    no longer than the kernel's index table."""
    p = _build.plan_gemm(m, n, r, 132, vec)
    assert (p.bm, p.bn, p.groups) == _build.PIPE_TILES[p.tile]
    assert p.vec == vec
    assert p.per % _build.PIPE_BK == 0 and p.splits >= 1
    assert (p.splits - 1) * p.per < r <= p.splits * p.per
    if p.splits > 1:
        assert p.per >= _build.PIPE_BK * _build.MIN_CHUNKS_PER_SPLIT
    if not vec:
        assert min(p.per, r) <= _build.PIPE_TABLE_MAX
    assert p.path == ("vec16" if vec else "general")


def test_pipe_plan_splits_only_what_does_not_fill_the_card():
    # VGG-16's conv1_2: 392 tiles of 128x64 fill 132 SMs three times over
    assert _build.plan_gemm(50176, 64, 576, 132, True).splits == 1
    # ResNet-50's conv5 3x3 at batch 1: 49 pixels, 8 tiles of 64x64, so
    # the reduction is cut across blocks and inside them
    p = _build.plan_gemm(49, 512, 4608, 132, True)
    assert (p.bm, p.bn) == (64, 64) and p.splits > 1
    assert p.tiles(49, 512) * p.splits * p.groups >= 132
    # the model: more splits only while they shorten the busiest SM's work
    for m, n, r in GEMMS:
        best = _build.plan_gemm(m, n, r, 132, True)
        one = _build.GemmPlan(best.tile, best.bm, best.bn, best.groups, 1,
                              -(-r // 16) * 16, True)
        assert (_build.pipe_cycles(m, n, best, 132)
                <= _build.pipe_cycles(m, n, one, 132))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vec_path_needs_whole_vectors_and_alignment(dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    x, w = torch.zeros(2, 5, 5, 32, dtype=dtype), torch.zeros(32, 64,
                                                             dtype=dtype)
    assert _build.vec_path(32, 64, x, w, None)
    assert not _build.vec_path(3, 64, x, w, None)        # C off the chunk
    assert not _build.vec_path(24, 64, x, w, None)
    assert not _build.vec_path(32, 24 // es, x, w, None)  # K of 24 bytes
    assert _build.vec_path(32, 16 // es, x, w, None)
    odd = torch.zeros(2 * 5 * 5 * 32 + 1, dtype=dtype)[1:].view(2, 5, 5, 32)
    assert odd.data_ptr() % 16 and not _build.vec_path(32, 64, odd, w, None)
    assert not _build.vec_path(32, 64, x, w, odd)        # the residual


def test_wrappers_plan_the_path_from_their_operands():
    x = torch.zeros(1, 14, 14, 64)
    w = torch.zeros(3, 3, 64, 64)
    p = t_conv.launch_plan(x, w, stride=1, padding=1, n_sms=132)
    assert p == _build.plan_gemm(196, 64, 576, 132, True)
    odd = torch.zeros(14 * 14 * 64 + 1)[1:].view(1, 14, 14, 64)
    assert t_conv.launch_plan(odd, w, padding=1, n_sms=132).path == "general"
    assert t_conv.launch_plan(torch.zeros(1, 8, 8, 3), torch.zeros(
        7, 7, 3, 64), stride=2, padding=3, n_sms=132).path == "general"
    # a strided 1x1 plans over its subsampled rows
    p = t_mm.act_plan(torch.zeros(1, 29, 29, 96), torch.zeros(96, 128),
                      stride=2, n_sms=132)
    assert p == _build.plan_gemm(15 * 15, 128, 96, 132, True)
    assert t_mm.act_plan(torch.zeros(300, 97), torch.zeros(97, 40),
                         n_sms=132).path == "general"


def test_pipe_workspace_and_shared_counters():
    x = torch.zeros(1, 7, 7, 512)
    one = _build.plan_gemm(50176, 64, 576, 132, True)
    assert _build.pipe_workspace(x, one, 50176, 64) == (None, None)
    p = _build.plan_gemm(49, 512, 4608, 132, True)
    ws, tickets = _build.pipe_workspace(x, p, 49, 512)
    assert ws.dtype == torch.float32
    assert ws.numel() >= p.splits * p.tiles(49, 512) * p.bm * p.bn
    # one partial-sum buffer a device, grown on demand
    assert _build.pipe_workspace(x, p, 49, 512)[0] is ws
    assert tickets.dtype == torch.int32 and not tickets.any()
    assert tickets.numel() >= p.tiles(49, 512)
    # one buffer a device, grown on demand, shared with decode attention
    assert _build.ticket_counters(x.device, 3) is tickets
    big = _build.ticket_counters(x.device, tickets.numel() + 5)
    assert big.numel() == tickets.numel() + 5 and not big.any()
    assert _build.ticket_counters(x.device, 1) is big


# plan_gemm's (tile code, splits, per) at every conv2d and act-stationary
# shape of the main path (ResNet-50 dense and sparse, VGG-16, batch 1) and
# of GEMMS, keyed (M, N, R, vec): the values it gave when the CNN loop was
# tuned.  The weight-stationary planner must leave them as they are.
PINNED_PLANS = {
    (49, 256, 2304, True): (2, 18, 128), (49, 512, 4608, True): (2, 15, 320),
    (196, 128, 512, True): (2, 8, 64), (196, 128, 1024, True): (2, 16, 64),
    (196, 128, 1152, True): (2, 9, 128), (196, 256, 512, True): (2, 8, 64),
    (196, 256, 1024, True): (2, 8, 128), (196, 256, 2304, True): (2, 8, 288),
    (196, 512, 4608, True): (2, 4, 1152), (196, 1024, 128, True): (2, 2, 64),
    (196, 1024, 256, True): (2, 2, 128), (196, 1024, 512, True): (2, 2, 256),
    (784, 64, 256, True): (2, 4, 64), (784, 64, 512, True): (2, 8, 64),
    (784, 64, 576, True): (2, 9, 64), (784, 128, 256, True): (2, 4, 64),
    (784, 128, 512, True): (2, 4, 128), (784, 128, 1152, True): (2, 5, 240),
    (784, 512, 64, True): (2, 1, 64), (784, 512, 128, True): (2, 1, 128),
    (784, 512, 256, True): (2, 1, 256), (784, 512, 2304, True): (1, 5, 464),
    (784, 512, 4608, True): (1, 5, 928), (3136, 32, 64, True): (2, 1, 64),
    (3136, 32, 256, True): (2, 2, 128), (3136, 32, 288, True): (2, 2, 144),
    (3136, 64, 64, True): (2, 1, 64), (3136, 64, 256, True): (2, 2, 128),
    (3136, 64, 576, True): (2, 2, 288), (3136, 256, 32, True): (1, 1, 32),
    (3136, 256, 64, True): (2, 1, 64), (3136, 256, 1152, True): (1, 4, 288),
    (3136, 256, 2304, True): (1, 4, 576),
    (12544, 64, 147, False): (1, 2, 80), (12544, 128, 576, True): (0, 2, 288),
    (12544, 128, 1152, True): (0, 2, 576), (50176, 64, 27, False): (0, 1, 32),
    (50176, 64, 576, True): (0, 1, 576),
    # GEMMS not on the main path
    (12544, 64, 147, True): (1, 2, 80), (50176, 64, 27, True): (0, 1, 32),
    (300, 40, 64, True): (2, 1, 64), (1, 5, 17, True): (2, 1, 32),
    (513, 257, 129, True): (2, 2, 80), (64, 67, 1179, True): (2, 10, 128),
    (7, 9, 40000, True): (2, 90, 448), (1, 1, 1, True): (1, 1, 16),
}


def _main_path_gemms():
    """(kernel, M, N, R or C, vec) of every CNN kernel call at batch 1."""
    from repro_torch.core import networks
    layers = [layer for sparse in (False, True)
              for layer in networks.resnet50_conv_layers(sparse)
              + networks.resnet50_projection_shortcuts(sparse)]
    out = []
    for layer in layers + networks.vgg16_conv_layers():
        vec = layer.IC % _build.PIPE_BK == 0
        if layer.FL > 1:
            ol = (layer.IL - layer.FL + 2 * layer.Z) // layer.S + 1
            out.append(("conv2d", ol * ol, layer.K,
                        layer.FL ** 2 * layer.IC, vec))
        else:
            ol = -(-layer.IL // layer.S)
            kind = ("weight" if ol * ol < 128 else "act")
            out.append((kind, ol * ol, layer.K, layer.IC, vec))
    return out


def test_pinned_plans_cover_the_main_path():
    pipe = {g[1:] for g in _main_path_gemms() if g[0] != "weight"}
    assert pipe <= set(PINNED_PLANS)
    assert {(m, n, r, True) for m, n, r in GEMMS} <= set(PINNED_PLANS)


@pytest.mark.parametrize("m,n,r,vec", sorted(PINNED_PLANS))
def test_pipe_plans_are_pinned(m, n, r, vec):
    p = _build.plan_gemm(m, n, r, 132, vec)
    assert (p.tile, p.splits, p.per) == PINNED_PLANS[m, n, r, vec]


# (M, N, C, vec) of the weight-stationary calls: ResNet-50's conv5 1x1s at
# batch 1, dense and sparse, then ragged ones (no C here is whole chunks)
WS_MAIN = sorted({g[1:] for g in _main_path_gemms() if g[0] == "weight"})
WS_GEMMS = WS_MAIN + [(m, k, c, False) for m in (1, 49, 64, 65, 97, 127)
                      for c in (61, 193, 4099) for k in (37, 89, 1031)]


@pytest.mark.parametrize("m,n,c,vec", WS_GEMMS)
def test_ws_plan_holds_the_rows_in_one_tile(m, n, c, vec):
    """One row tile (each weight element read by one block), every channel
    in exactly one split of whole chunks, at least MIN_CHUNKS_PER_SPLIT of
    them when split, on the general path no split longer than the index
    table, and a workspace that pipe_workspace gives."""
    p = _build.plan_weight_stationary(m, n, c, 132, vec)
    assert (p.bm, p.bn, p.groups) == _build.PIPE_TILES[p.tile]
    assert p.bm >= m and p.vec == vec
    assert p.per % _build.PIPE_BK == 0 and p.splits >= 1
    assert (p.splits - 1) * p.per < c <= p.splits * p.per
    if p.splits > 1:
        assert p.per >= _build.PIPE_BK * _build.MIN_CHUNKS_PER_SPLIT
    if not vec:
        assert min(p.per, c) <= _build.PIPE_TABLE_MAX
    ws, tickets = _build.pipe_workspace(torch.zeros(1), p, m, n)
    if p.splits == 1:
        assert ws is None and tickets is None
    else:
        assert ws.numel() >= p.splits * p.tiles(m, n) * p.bm * p.bn
        assert tickets.numel() >= p.tiles(m, n) and not tickets.any()


def test_ws_plan_of_the_conv5_calls_splits_c_in_the_launch():
    # 49 rows in one 64-row tile; the column slabs alone do not fill the
    # card, so C is split and the splits meet in the same launch
    assert len(WS_MAIN) == 7
    for m, n, c, vec in WS_MAIN:
        p = _build.plan_weight_stationary(m, n, c, 132, vec)
        assert m == 49 and p.bm == 64 and vec and p.splits > 1
    # above one tile's rows the weights are read once per 128-row tile
    assert _build.plan_weight_stationary(200, 64, 64, 132, True).bm == 128
    x, w = torch.zeros(1, 14, 14, 1024), torch.zeros(1024, 512)
    assert t_mm.ws_plan(x, w, stride=2, n_sms=132) == \
        _build.plan_weight_stationary(49, 512, 1024, 132, True)
    odd = torch.zeros(49 * 512 + 1)[1:].view(49, 512)
    assert t_mm.ws_plan(odd, torch.zeros(512, 256), n_sms=132).path == \
        "general"


def test_engine_resolution():
    x, w = torch.randn(2, 4, 4, 3), torch.randn(3, 3, 3, 5)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.conv2d(x, w, padding=1, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.conv2d(x, w, padding=1, impl="pallas")
    auto = ops.conv2d(x, w, padding=1, epilogue=Epilogue(relu=True))
    ref = ops.conv2d(x, w, padding=1, impl="ref", epilogue=Epilogue(relu=True))
    assert torch.equal(auto, ref)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        _build.launch_operands("conv2d", x, w, (2, 4, 4, 5), None, None, None)
