"""CARLA dual-stationarity GEMM — the paper's 1x1-mode operand swap.

Two CUDA kernels (``csrc/matmul.cu``) compute the same ``(M, C) @ (C, K)``
with the fused flush epilogue, mirroring the paper's §III.B / §III.C
reconfiguration:

* ``matmul_act_stationary`` (§III.B analogue, M >= 128 rows): a tiled GEMM
  over (M/64, K/64) blocks with the C loop inside each block.
* ``matmul_weight_stationary`` (§III.C analogue, M < 128 rows): each block
  owns all M rows and a 32-column weight slab, so each weight element is
  read once.

Where the output tiles are too few to fill the card, either kernel splits C
over blocks and a second pass sums the splits and applies the flush
(``_build.plan_splits``).

``matmul`` picks the variant via ``core.modes.select_stationarity`` — the
software twin of CARLA's controller.

``x`` is either a plain ``(M, C)`` matrix or an NHWC ``(B, H, W, C)`` tensor
read at ``stride``: then row m is pixel ``(b, oh*stride, ow*stride)`` and the
result is ``(B, OH, OW, K)``.  The kernels fold the stride into their row
addressing, so a strided 1x1 conv never materialises ``x[:, ::s, ::s]``.

``matmul_plain`` is the plain PyTorch version of both.  A tensor on the CPU
takes it; a CUDA tensor launches the kernel or raises.  Each wrapper's
``launches`` attribute counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.modes import Stationarity, select_stationarity
from . import _build
from .ref import conv1x1_ref, matmul_ref

# Tiles of csrc/matmul.cu; tests/test_torch_kernels.py holds them in sync.
AS_BM, AS_BN = 64, 64          # AsTile: rows, columns per block
WS_BN = 32                     # WsTile64 / WsTile128: columns per block
WS_BMS = (64, 128)             # ... rows per block: all M < 128 rows
BK = 16                        # reduction chunk, both kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name: [_I] + [_P] * 7 + [_I] * 11 + [_P]
               for name in ("carla_mm_act_stationary",
                            "carla_mm_weight_stationary")}


def _up(n: int, t: int) -> int:
    return -(-n // t) * t


def ws_bm(m: int) -> int:
    """Row tile of the weight-stationary kernel: one tile holds all rows."""
    return WS_BMS[0] if m <= WS_BMS[0] else WS_BMS[1]


def tile_util(m: int, c: int, k: int, stationarity: str) -> float:
    """Logical FLOPs / FLOPs of the padded tiles the kernel runs."""
    if m * c * k == 0:
        return 1.0
    if stationarity == Stationarity.WEIGHT_STATIONARY.value:
        padded = _up(m, ws_bm(m)) * _up(k, WS_BN) * _up(c, BK)
    else:
        padded = _up(m, AS_BM) * _up(k, AS_BN) * _up(c, BK)
    return (m * c * k) / padded


def _rows(x: torch.Tensor, stride: int):
    """(M, C, H, W, OH, OW, output shape) of the GEMM view of x."""
    if x.ndim == 2:
        if stride != 1:
            raise ValueError("a stride needs an NHWC (B, H, W, C) input")
        m, c = x.shape
        return m, c, 1, 1, 1, 1, None
    b, h, wd, c = x.shape
    oh, ow = -(-h // stride), -(-wd // stride)
    return b * oh * ow, c, h, wd, oh, ow, (b, oh, ow)


def matmul_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 scale=None, bias=None, relu: bool = False,
                 residual=None) -> torch.Tensor:
    """The kernels' function in plain PyTorch (fp32 accumulation, x's dtype)."""
    if x.ndim == 2:
        y = matmul_ref(x, w, scale=scale, bias=bias, relu=relu,
                       residual=residual)
    else:
        y = conv1x1_ref(x, w, stride, scale=scale, bias=bias, relu=relu,
                        residual=residual)
    return y.to(x.dtype)


def _launch(fn: str, x, w, stride, scale, bias, relu, residual, bm: int,
            bn: int) -> torch.Tensor:
    """Check, plan the C splits, launch one of the two kernels."""
    m, c, h, wd, oh, ow, lead = _rows(x, stride)
    c2, k = w.shape
    if c != c2:
        raise ValueError(f"{fn}: x has {c} channels, w expects {c2}")
    out_shape = (m, k) if lead is None else (*lead, k)
    code, sc, bi = _build.launch_operands(fn, x, w, out_shape, scale, bias,
                                          residual)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    splits, per, ws = _build.split_launch(x, -(-m // bm) * -(-k // bn), c,
                                          BK, m, k)
    lib = _build.load("matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = getattr(lib, "carla_mm_" + fn.removeprefix("matmul_"))(
            code, x.data_ptr(), w.data_ptr(), _build.ptr(sc), _build.ptr(bi),
            _build.ptr(residual), out.data_ptr(), _build.ptr(ws), m, c, k, h,
            wd, stride, oh, ow, splits, per, int(relu),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn)
    return out


def matmul_act_stationary(x: torch.Tensor, w: torch.Tensor, *,
                          stride: int = 1,
                          scale: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None,
                          relu: bool = False,
                          residual: torch.Tensor | None = None) -> torch.Tensor:
    """(M, C) @ (C, K) with the fused flush; 64x64 tiles, C looped inside."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, stride=stride, scale=scale, bias=bias,
                            relu=relu, residual=residual)
    out = _launch("matmul_act_stationary", x, w, stride, scale, bias, relu,
                  residual, AS_BM, AS_BN)
    matmul_act_stationary.launches += 1
    return out


def matmul_weight_stationary(x: torch.Tensor, w: torch.Tensor, *,
                             stride: int = 1,
                             scale: torch.Tensor | None = None,
                             bias: torch.Tensor | None = None,
                             relu: bool = False,
                             residual: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """(M, C) @ (C, K) for small M: every weight element is read once."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, stride=stride, scale=scale, bias=bias,
                            relu=relu, residual=residual)
    out = _launch("matmul_weight_stationary", x, w, stride, scale, bias, relu,
                  residual, ws_bm(_rows(x, stride)[0]), WS_BN)
    matmul_weight_stationary.launches += 1
    return out


matmul_act_stationary.launches = 0
matmul_weight_stationary.launches = 0


def gemm_rows(x: torch.Tensor, stride: int = 1) -> int:
    """M of the GEMM view: the rows of x, or its pixels read at stride."""
    return _rows(x, stride)[0]


def matmul(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           stationarity: Stationarity | None = None,
           **epilogue) -> torch.Tensor:
    """CARLA-style reconfigurable GEMM: pick residency from the M extent."""
    if stationarity is None:
        stationarity = select_stationarity(gemm_rows(x, stride))
    if stationarity == Stationarity.WEIGHT_STATIONARY:
        return matmul_weight_stationary(x, w, stride=stride, **epilogue)
    return matmul_act_stationary(x, w, stride=stride, **epilogue)
