"""Port parity: the LM kernels' plain versions against the Pallas kernels.

On the CPU the wrappers of ``repro_torch.kernels.{conv1d, flash_attention,
decode_attention}`` run their plain PyTorch versions (a CUDA kernel has no
interpret mode; ``chip_smoke.py`` holds the kernels to these plain versions
on the card).  Here they are held to ``repro``'s Pallas kernels run with
``interpret=True`` on the same numpy inputs, at the cheap shapes of
``tests/test_kernels.py`` (T <= 512), with its tolerances: conv1d
2e-4·FL (fp32) / 2e-2·FL (bf16); attention 1e-4 (fp32) and 2e-2 (bf16, one
bf16 step at |out| < 1 plus the rounding of p, which both round).

The rest checks what the card run relies on and the CPU can see: the
``conv1d_causal`` span against ``repro``'s, the Python constants and ctypes
signatures against the CUDA sources, and the operand checks.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv1d_causal as j_conv1d
from repro.kernels import decode_attention as j_decode
from repro.kernels import ops as j_ops
from repro.kernels.flash_attention import flash_attention_fused as j_flash
from repro.observability import trace as j_trace
from repro_torch.kernels import _build, ops
from repro_torch.kernels import conv1d as t_conv1d
from repro_torch.kernels import decode_attention as t_decode
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ref as t_ref
from repro_torch.observability import trace as t_trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this file's torch ops on one thread: under xdist the other
    workers' timing-based benchmark tests share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _err(got_t, want_j) -> float:
    return float(np.max(np.abs(got_t.float().numpy()
                               - np.asarray(want_j, np.float32))))


# ------------------------------- conv1d --------------------------------------
CONV1D_CASES = [(1, 16, 32, 4), (2, 33, 96, 4), (2, 64, 513, 2), (1, 8, 8, 3),
                # filter lengths no config has: the FL 1 instance and the
                # kernel that takes FL at run time
                (1, 16, 32, 1), (2, 33, 96, 5), (1, 40, 131, 7),
                (2, 17, 24, 9)]


@pytest.mark.parametrize("b,t,c,fl", CONV1D_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv1d_matches_pallas(b, t, c, fl, dtype):
    rng = np.random.default_rng(b + t + c + fl)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = rng.standard_normal((fl, c)).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    want = j_conv1d(jx, jw, interpret=True)
    got = t_conv1d.conv1d_causal(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    tol = (2e-2 if dtype == "bfloat16" else 2e-4) * fl
    assert _err(got, want) < tol


def test_conv1d_reads_a_strided_view():
    """Mamba2 hands the conv a column slice of the in_proj output."""
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal((2, 9, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 24)).astype(np.float32))
    view = full[..., 8:32]
    assert not view.is_contiguous() and view.stride(2) == 1
    torch.testing.assert_close(t_conv1d.conv1d_causal(view, w),
                               t_conv1d.conv1d_causal(view.contiguous(), w),
                               rtol=0, atol=0)
    assert t_conv1d.vector_width(view) == 4


def test_conv1d_span_matches_repro():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    with j_trace.capture() as jt:
        want = j_ops.conv1d_causal(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w))
    with t_trace.capture() as tt:
        got = ops.conv1d_causal(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(w))
    (js,), (ts,) = jt.find("kernels.conv1d_causal"), \
        tt.find("kernels.conv1d_causal")
    keys = ("impl", "x_shape", "w_shape", "dtype", "flops", "bytes_touched")
    assert {k: ts.attrs[k] for k in keys} == {k: js.attrs[k] for k in keys}
    assert _err(got, want) < 2e-2 * 4


# --------------------------- decode attention --------------------------------
DECODE_CASES = [(2, 256, 8, 2, 32, 64), (1, 1000, 4, 4, 64, 256),
                (2, 64, 6, 3, 16, 64), (2, 128, 4, 2, 256, 64),
                # head dims above 256: the wide kernel, unpadded
                (2, 128, 4, 2, 272, 64), (1, 200, 2, 1, 384, 64),
                (2, 96, 4, 4, 512, 32),
                # a row of 301 elements: no whole number of 16-byte pieces
                (2, 90, 4, 2, 301, 32)]


@pytest.mark.parametrize("b,s,h,kh,dh,bs", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_pallas(b, s, h, kh, dh, bs, dtype):
    rng = np.random.default_rng(s + h)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    ck = rng.standard_normal((b, s, kh, dh)).astype(np.float32)
    cv = rng.standard_normal((b, s, kh, dh)).astype(np.float32)
    pos = (np.arange(b) * (s // 2) + s // 3).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, ck, cv))
    want = j_decode(jq, jk, jv, jnp.asarray(pos), bs=bs)
    got = t_decode.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    assert _err(got, want) < ATTN_TOL[dtype]


# ---------------------------- flash attention --------------------------------
FLASH_CASES = [(1, 512, 4, 2, 32, 0, 0.0), (2, 512, 8, 4, 64, 128, 0.0),
               (1, 512, 4, 2, 32, 0, 30.0), (1, 256, 6, 3, 16, 0, 0.0),
               (1, 256, 4, 2, 256, 64, 50.0),   # gemma2's head dim
               # head dims above 256: the wide kernel, unpadded
               (1, 128, 4, 2, 272, 0, 0.0), (1, 128, 2, 2, 384, 32, 30.0),
               (1, 128, 4, 1, 512, 0, 50.0), (1, 128, 4, 2, 301, 20, 30.0)]


@pytest.mark.parametrize("b,t,h,kh,dh,win,cap", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_pallas(b, t, h, kh, dh, win, cap, dtype):
    rng = np.random.default_rng(t + h + win)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, dh)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = j_flash(jq, jk, jv, window=win, softcap=cap, bq=128, bk=128)
    got = t_flash.flash_attention(tq, tk, tv, window=win, softcap=cap)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    assert _err(got, want) < ATTN_TOL[dtype]


@pytest.mark.parametrize("win,cap", [(0, 0.0), (24, 30.0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_flash_scored_in_row_blocks_matches_one_block(monkeypatch, win,
                                                           cap, dtype):
    """A T past ``FLASH_REF_ROWS`` is scored that many query rows at a time,
    each block without the keys past its last row.  Cut to 20 rows at T 96
    (the last block partial, the window spanning blocks), it equals one
    unblocked score block (1e-6) and repro's Pallas kernel (ATTN_TOL)."""
    rng = np.random.default_rng(96 + win)
    q = rng.standard_normal((2, 96, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 96, 2, 32)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    whole = t_ref._flash_rows(tq, tk, tv, 0, win, cap)
    monkeypatch.setattr(t_ref, "FLASH_REF_ROWS", 20)
    blocked = t_ref.flash_attention_ref(tq, tk, tv, window=win, softcap=cap)
    assert tuple(blocked.shape) == tuple(whole.shape)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=1e-6)
    want = j_flash(jq, jk, jv, window=win, softcap=cap, bq=32, bk=32)
    assert _err(blocked, want) < ATTN_TOL[dtype]


def test_flash_takes_ragged_lengths_the_pallas_wrapper_refuses():
    """Any T (the Pallas wrapper asserts T % bq == 0): row t of a ragged run
    equals row t of the same run with more keys appended."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 4, 16)).astype(
        np.float32)) for _ in range(3))
    full = t_flash.flash_attention(q, k, v)
    part = t_flash.flash_attention(q[:, :37], k[:, :37], v[:, :37])
    torch.testing.assert_close(part, full[:, :37], rtol=1e-6, atol=1e-6)


def test_cpu_paths_count_no_launch():
    wrappers = (t_conv1d.conv1d_causal, t_flash.flash_attention,
                t_decode.decode_attention)
    before = [f.launches for f in wrappers]
    t_conv1d.conv1d_causal(torch.randn(1, 5, 8), torch.randn(4, 8))
    t_flash.flash_attention(*(torch.randn(1, 6, 2, 16) for _ in range(3)))
    t_decode.decode_attention(torch.randn(2, 2, 16),
                              *(torch.randn(2, 9, 2, 16) for _ in range(2)),
                              torch.tensor([0, 8], dtype=torch.int32))
    assert [f.launches for f in wrappers] == before


def test_kernel_operand_checks_refuse_cpu_tensors():
    q = torch.randn(1, 4, 2, 16)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        _build.attention_operands("flash_attention", q=q, k=q, v=q)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.conv1d_causal(torch.randn(1, 4, 8), torch.randn(4, 8),
                          impl="cuda")


# --------------------------- the CUDA sources --------------------------------
CSRC = Path(_build.__file__).parent / "csrc"
_CTYPE_KIND = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}


def _c_signatures(source: str) -> dict:
    text = (CSRC / source).read_text()
    sigs = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for a in args.split(","):
            a = a.strip()
            kind = "p" if "*" in a else {"int": "i", "float": "f"}[a.split()[0]]
            kinds.append(kind)
        sigs[name] = kinds
    return sigs


@pytest.mark.parametrize("module,source", [
    (t_conv1d, "conv1d.cu"), (t_flash, "flash_attention.cu"),
    (t_decode, "decode_attention.cu")])
def test_ctypes_signatures_match_the_c_entry_points(module, source):
    """Every pointer and the stream must be c_void_p, floats c_float."""
    c_sigs = _c_signatures(source)
    assert set(c_sigs) == set(module._SIGNATURES)
    for name, argtypes in module._SIGNATURES.items():
        assert [_CTYPE_KIND[t] for t in argtypes] == c_sigs[name], name


def _constant(source: str, name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", (CSRC / source).read_text())
    return int(m.group(1))


def _switch_cases(source: str) -> tuple:
    text = (CSRC / source).read_text()
    return tuple(int(v) for v in re.findall(r"case (\d+): return", text))


def test_python_constants_match_the_sources():
    assert (_constant("flash_attention.cu", "FA_BQ"),
            _constant("flash_attention.cu", "FA_BK")) == (t_flash.BQ,
                                                          t_flash.BK)
    assert (_constant("flash_attention.cu", "FA_MMA_BQ"),
            _constant("flash_attention.cu", "FA_MMA_BK")) == (t_flash.MMA_BQ,
                                                              t_flash.MMA_BK)
    assert _constant("decode_attention.cu", "DA_CH") == t_decode.CHUNK
    assert _switch_cases("flash_attention.cu") == t_flash.HEAD_DIMS
    assert _switch_cases("decode_attention.cu") == t_flash.HEAD_DIMS
    assert _switch_cases("conv1d.cu") == t_conv1d.FLS
    # the wide kernels' widest head dim, in both sources
    assert _constant("flash_attention.cu", "FA_WIDE_MAX_DH") == \
        t_flash.WIDE_MAX_HEAD_DIM
    assert _constant("decode_attention.cu", "DA_WIDE_MAX_DH") == \
        t_flash.WIDE_MAX_HEAD_DIM


def test_decode_workspace_covers_every_chunk():
    # (B, S, H, Kh, dh) = zamba2's decode on 132 SMs holding 4 blocks each:
    # 4 splits of 9, 9, 9 and 6 tiles, 512 blocks in one wave
    plan = t_decode.launch_plan(4, 2080, 32, 32, 80, 4 * 132)
    assert (plan.splits, plan.split_tiles) == (4, 9)
    assert plan.ws_floats == 4 * 32 * 4 * 1 * (2 + 80)
    plan = t_decode.launch_plan(2, 64, 6, 3, 16, 4 * 132)
    assert (plan.splits, plan.split_tiles) == (1, 1)
    assert plan.ws_floats == 2 * 3 * 1 * 2 * 18


@pytest.mark.parametrize("s", [1, 127, 128, 129, 2080])
@pytest.mark.parametrize("b,h,kh,dh", [(4, 32, 32, 80), (1, 4, 1, 64),
                                       (3, 8, 2, 128)])
@pytest.mark.parametrize("slots", [1, 4 * 132])
def test_decode_launch_plan_covers_every_row_and_head(s, b, h, kh, dh,
                                                      slots):
    """The splits cover rows 0..S-1 exactly once in whole CHUNK-row tiles,
    none empty (the C entry point refuses that), in one wave where the card
    holds B * Kh blocks or more; the workspace holds (max, sum, dh outputs)
    for every (b, kh, split, head); one ticket counter per (b, kh) -- the C
    side's indexing, walked here."""
    plan = t_decode.launch_plan(b, s, h, kh, dh, slots)
    rows_per_split = plan.split_tiles * t_decode.CHUNK
    rows = [r for i in range(plan.splits)
            for r in range(i * rows_per_split, (i + 1) * rows_per_split)
            if r < s]
    assert rows == list(range(s))
    assert (plan.splits - 1) * rows_per_split < s
    assert b * kh * plan.splits <= max(slots, b * kh)     # one wave
    g = h // kh
    n_ws = b * kh * plan.splits * g            # ws_index(B-1, KH-1, ...) + 1
    last = (((b - 1) * kh + kh - 1) * plan.splits + plan.splits - 1) * g \
        + g - 1
    assert last == n_ws - 1
    assert plan.ws_floats == 2 * n_ws + n_ws * dh
    assert plan.tickets == b * kh
