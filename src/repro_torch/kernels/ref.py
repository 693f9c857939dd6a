"""Plain PyTorch versions of every CUDA kernel (the ground truth for tests).

All convs are NHWC / HWIO at the interface, matching the kernels.  They
accumulate in fp32 and apply the epilogue in the kernels' order.  On CUDA
they run with TF32 off: cuDNN's convolutions default to TF32, which keeps
about three decimal digits and would miss the fp32 tolerance of
2e-4 · scale that the kernels are held to.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _exact_fp32(t: torch.Tensor):
    """Context that forbids TF32 in cuDNN and checks it is off for matmuls."""
    if t.device.type != "cuda":
        return contextlib.nullcontext()
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("the fp32 reference needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def epilogue_ref(y: torch.Tensor, scale=None, bias=None, relu: bool = False,
                 residual=None) -> torch.Tensor:
    """The epilogue the fused kernels apply at flush, in fp32, unfused.

    Order matches the kernels (and the ResNet bottleneck):
    scale/bias -> residual add -> ReLU.
    """
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: int = 0, *, scale=None, bias=None, relu: bool = False,
               residual=None) -> torch.Tensor:
    """x: (B, H, W, C), w: (FH, FW, C, K) -> (B, OH, OW, K). fp32 accumulate."""
    with _exact_fp32(x):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1),
                     stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1).contiguous()
    return epilogue_ref(y, scale, bias, relu, residual)


def conv1x1_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                scale=None, bias=None, relu: bool = False,
                residual=None) -> torch.Tensor:
    """x: (B, H, W, C), w: (C, K); pointwise conv == GEMM over channels."""
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    b, h, wd, c = x.shape
    y = matmul_ref(x.reshape(b * h * wd, c), w).reshape(b, h, wd, -1)
    return epilogue_ref(y, scale, bias, relu, residual)


def matmul_ref(x: torch.Tensor, w: torch.Tensor, *, scale=None, bias=None,
               relu: bool = False, residual=None) -> torch.Tensor:
    """x: (M, C), w: (C, K) -> (M, K) with fp32 accumulation."""
    with _exact_fp32(x):
        y = torch.matmul(x.float(), w.float())
    return epilogue_ref(y, scale, bias, relu, residual)
