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
split planner, engine resolution and the launch counters.
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


def _tiles(source: str) -> dict:
    text = (CSRC / source).read_text()
    return {name: tuple(int(v) for v in args.split(","))
            for name, args in re.findall(r"using (\w+) = Tile<([\d, ]+)>;",
                                         text)}


def test_python_tile_constants_match_the_sources():
    """conv2d and act-stationary: the tiles and constants of gemm_pipe.cuh
    (PIPE_TILES by tile code); weight-stationary: matmul.cu's Tile<>s."""
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
        assert '#include "gemm_pipe.cuh"' in (CSRC / src).read_text()
    mm = _tiles("matmul.cu")
    assert set(mm) == {"WsTile64", "WsTile128"}
    assert {mm["WsTile64"][:3], mm["WsTile128"][:3]} == {
        (bm, t_mm.WS_BN, t_mm.BK) for bm in t_mm.WS_BMS}


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
    assert {"conv2d.cu", "matmul.cu", "gemm_pipe.cuh", "tile_gemm.cuh",
            "numeric.cuh"} <= names
    assert [p.name for p in _build.sources()] == [
        "conv1d.cu", "conv2d.cu", "decode_attention.cu", "flash_attention.cu",
        "matmul.cu"]
    assert len(_build.source_hash()) == 16
    gitignore = (Path(__file__).parents[1] / ".gitignore").read_text()
    assert "src/repro_torch/kernels/_build/" in gitignore.split()


@pytest.mark.parametrize("tiles,reduction", [
    (8, 4608), (16, 2304), (49, 576), (196, 147), (64, 1024), (16, 2048),
    (1, 48), (3, 17), (200, 100000)])
def test_split_plan_covers_the_reduction(tiles, reduction):
    splits, per = _build.plan_splits(tiles, reduction, 16, 132)
    assert per % 16 == 0 and splits >= 1
    assert (splits - 1) * per < reduction <= splits * per
    if tiles >= 132:
        assert splits == 1
    if splits > 1:
        assert per >= 16 * _build.MIN_CHUNKS_PER_SPLIT
        assert tiles * splits >= 132 or per == 16 * _build.MIN_CHUNKS_PER_SPLIT


def test_tile_util_counts_padding():
    # 64 pixels x 64 channels: the 64x64 tile, nothing padded
    assert t_conv.tile_util((1, 8, 8, 16), (3, 3, 16, 64), 1, 1) == 1.0
    # the stem's R = 147 pads to 160 (10 chunks of 16)
    m = 112 * 112
    plan = _build.plan_gemm(m, 64, 147, 132, False)
    assert t_conv.tile_util((1, 224, 224, 3), (7, 7, 3, 64), 2, 3) == (
        m * 64 * 147 / (-(-m // plan.bm) * plan.bm * 64 * 160))
    # act-stationary pads M and K to its plan's tile, C to whole chunks
    for m, c, k in ((64, 32, 64), (64, 64, 32), (300, 97, 40)):
        p = _build.plan_gemm(m, k, c, 132, c % 16 == 0)
        want = m * c * k / (-(-m // p.bm) * p.bm * -(-k // p.bn) * p.bn
                            * -(-c // 16) * 16)
        assert t_mm.tile_util(m, c, k, "activation_stationary") == want
    assert t_mm.tile_util(64, 32, 64, "activation_stationary") == 1.0
    assert t_mm.tile_util(128, 64, 64, "activation_stationary") == 1.0
    assert t_mm.tile_util(49, 512, 2048, "weight_stationary") == 49 / 64
    assert t_mm.tile_util(100, 16, 32, "weight_stationary") == 100 / 128


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
