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
    conv = _tiles("conv2d.cu")["ConvTile"]
    assert conv[:3] == (t_conv.BM, t_conv.BN, t_conv.BK)
    mm = _tiles("matmul.cu")
    assert mm["AsTile"][:3] == (t_mm.AS_BM, t_mm.AS_BN, t_mm.BK)
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
    assert {"conv2d.cu", "matmul.cu", "tile_gemm.cuh", "numeric.cuh"} <= names
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
    assert t_conv.tile_util((1, 8, 8, 16), (3, 3, 16, 64), 1, 1) == 1.0
    assert t_mm.tile_util(64, 32, 64, "activation_stationary") == 1.0
    assert t_mm.tile_util(49, 512, 2048, "weight_stationary") == 49 / 64
    assert t_mm.tile_util(100, 16, 32, "weight_stationary") == 100 / 128


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
