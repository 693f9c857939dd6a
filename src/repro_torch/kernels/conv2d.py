"""CARLA serial-accumulation convolution — the CUDA kernel's wrapper.

``conv2d`` runs ``csrc/conv2d.cu``, an implicit-GEMM convolution (M = output
pixels, N = K, reduction = FH·FW·C) with the fused flush epilogue
(scale/bias → residual → ReLU on the fp32 accumulator, one store).  The
source's header note says which Pallas kernel it replaces, what bounds it on
the H100 and how its design answers that.

``conv2d_plain`` is the plain PyTorch version of the same function.  A
tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``conv2d.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import conv2d_ref

# Tile of csrc/conv2d.cu (ConvTile): output pixels, output channels, and the
# reduction chunk.  tests/test_torch_kernels.py holds the two in sync.
BM, BN, BK = 64, 64, 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"carla_conv2d": [_I] + [_P] * 7 + [_I] * 14 + [_P]}


def out_hw(h: int, w: int, fh: int, fw: int, stride: int,
           padding: int) -> tuple[int, int]:
    return ((h - fh + 2 * padding) // stride + 1,
            (w - fw + 2 * padding) // stride + 1)


def tile_util(x_shape, w_shape, stride: int = 1, padding: int = 0) -> float:
    """Logical FLOPs / FLOPs of the padded tiles the kernel runs."""
    b, h, w, c = x_shape
    fh, fw, _, k = w_shape
    oh, ow = out_hw(h, w, fh, fw, stride, padding)
    m, r = b * oh * ow, fh * fw * c
    if m * k * r == 0:
        return 1.0
    up = lambda n, t: -(-n // t) * t
    return (m * k * r) / (up(m, BM) * up(k, BN) * up(r, BK))


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: int = 0, scale=None, bias=None, relu: bool = False,
                 residual=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 accumulation, x's dtype)."""
    return conv2d_ref(x, w, stride, padding, scale=scale, bias=bias,
                      relu=relu, residual=residual).to(x.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: int = 0, scale: torch.Tensor | None = None,
           bias: torch.Tensor | None = None, relu: bool = False,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, H, W, C), w: (FH, FW, C, K) -> (B, OH, OW, K) in x's dtype.

    scale/bias ((K,)), residual ((B, OH, OW, K), contiguous, x's dtype) and
    relu are fused into the flush.
    """
    b, h, wd, cin = x.shape
    fh, fw, cin2, k = w.shape
    if cin != cin2:
        raise ValueError(f"conv2d: x has {cin} channels, w expects {cin2}")
    oh, ow = out_hw(h, wd, fh, fw, stride, padding)
    if x.device.type == "cpu":
        return conv2d_plain(x, w, stride=stride, padding=padding, scale=scale,
                            bias=bias, relu=relu, residual=residual)
    out_shape = (b, oh, ow, k)
    code, sc, bi = _build.launch_operands("conv2d", x, w, out_shape, scale,
                                          bias, residual)
    lib = _build.load("conv2d", _SIGNATURES)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    m = b * oh * ow
    splits, per, ws = _build.split_launch(
        x, -(-m // BM) * -(-k // BN), fh * fw * cin, BK, m, k)
    with torch.cuda.device(x.device):
        err = lib.carla_conv2d(
            code, x.data_ptr(), w.data_ptr(), _build.ptr(sc), _build.ptr(bi),
            _build.ptr(residual), out.data_ptr(), _build.ptr(ws), b, h, wd,
            cin, k, fh, fw, stride, padding, oh, ow, splits, per, int(relu),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
