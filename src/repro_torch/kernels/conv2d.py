"""CARLA serial-accumulation convolution — the CUDA kernel's wrapper.

``conv2d`` runs ``csrc/conv2d.cu``, an implicit-GEMM convolution (M = output
pixels, N = K, reduction = FH·FW·C) with the fused flush epilogue
(scale/bias → residual → ReLU on the fp32 accumulator, one store), on the
pipelined loop of ``csrc/gemm_pipe.cuh``.  ``launch_plan`` picks its block
tile, its split of the reduction and its gather path (``vec16`` or
``general``, ``_build.plan_gemm`` and ``_build.vec_path``), or takes the
tile and split count of a tuned entry (``tiles``, a
``core.autotune.TileConfig``), checked as the C side checks it: a plan the
launch cannot take raises.  The source's
header note says which Pallas kernel it replaces, what bounds it on the H100
and how its design answers that.

``conv2d_plain`` is the plain PyTorch version of the same function.  A
tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``conv2d.launches`` counts launches.  Forward only: no training path
reaches this kernel (serving runs it), and its output carries no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import conv2d_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"carla_conv2d": [_I] + [_P] * 8 + [_I] * 16 + [_P]}


def out_hw(h: int, w: int, fh: int, fw: int, stride: int,
           padding: int) -> tuple[int, int]:
    return ((h - fh + 2 * padding) // stride + 1,
            (w - fw + 2 * padding) // stride + 1)


def launch_plan(x, w, *, stride: int = 1, padding: int = 0, residual=None,
                n_sms: int | None = None, tiles=None) -> _build.GemmPlan:
    """Tile, split and gather path of the launch for these operands (on
    x's device, or on a card of ``n_sms`` SMs; or the tuned ``tiles``)."""
    b, h, wd, cin = x.shape
    fh, fw, _, k = w.shape
    oh, ow = out_hw(h, wd, fh, fw, stride, padding)
    vec = _build.vec_path(cin, k, x, w, residual)
    if tiles is not None:
        return _build.fixed_plan(tiles.tile, tiles.splits, fh * fw * cin, vec)
    return _build.plan_gemm(b * oh * ow, k, fh * fw * cin,
                            n_sms or _build.sm_count(x.device), vec)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: int = 0, scale=None, bias=None, relu: bool = False,
                 residual=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 accumulation, x's dtype)."""
    return conv2d_ref(x, w, stride, padding, scale=scale, bias=bias,
                      relu=relu, residual=residual).to(x.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: int = 0, scale: torch.Tensor | None = None,
           bias: torch.Tensor | None = None, relu: bool = False,
           residual: torch.Tensor | None = None, tiles=None) -> torch.Tensor:
    """x: (B, H, W, C), w: (FH, FW, C, K) -> (B, OH, OW, K) in x's dtype.

    scale/bias ((K,)), residual ((B, OH, OW, K), contiguous, x's dtype) and
    relu are fused into the flush; ``tiles`` names a tuned plan.
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
    plan = launch_plan(x, w, stride=stride, padding=padding,
                       residual=residual, tiles=tiles)
    ws, tickets = _build.pipe_workspace(x, plan, b * oh * ow, k)
    with torch.cuda.device(x.device):
        err = lib.carla_conv2d(
            code, x.data_ptr(), w.data_ptr(), _build.ptr(sc), _build.ptr(bi),
            _build.ptr(residual), out.data_ptr(), _build.ptr(ws),
            _build.ptr(tickets), b, h, wd, cin, k, fh, fw, stride, padding,
            oh, ow, plan.tile, int(plan.vec), plan.splits, plan.per,
            int(relu), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
