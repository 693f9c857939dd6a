"""Operations the plain forwards share: NCHW convolution from HWIO weights,
max-pooling with XLA's SAME padding, and the precision they run in."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(device: torch.device, tf32: bool):
    """fp32 with TF32 off (the reference), or TF32 on (its control).

    cuDNN is switched off, so a convolution is PyTorch's own im2col and
    cuBLAS product: no FFT or Winograd algorithm rounds differently from a
    plain sum, and the one TF32 switch that matters is the matmul's.
    """
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 stored mantissa bits, to nearest
    even: what TF32 does to a product's operands, for the CPU, which has
    no TF32 unit."""
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def _operands(tf32: bool, *ts):
    if tf32 and ts[0].device.type == "cpu":
        return tuple(round_tf32(t) for t in ts)
    return ts


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0,
         tf32: bool = False) -> torch.Tensor:
    """x NCHW; w HWIO (FH, FW, C, K), or (C, K) for a 1x1."""
    if w.dim() == 2:
        w = w[None, None]
    x, w = _operands(tf32, x, w.permute(3, 2, 0, 1))
    return F.conv2d(x, w, stride=stride, padding=pad)


def matmul(a: torch.Tensor, b: torch.Tensor,
           tf32: bool = False) -> torch.Tensor:
    a, b = _operands(tf32, a, b)
    return a @ b


def max_pool(x: torch.Tensor, window: int, stride: int,
             same: bool) -> torch.Tensor:
    """NCHW max-pool.  ``same`` pads as XLA's SAME: the output has
    ceil(n / stride) positions, and the total pad splits low = total // 2,
    high = the rest, with -inf (on ResNet's 112 x 112 stem: low 0, high 1).
    """
    if same:
        pads = []
        for n in (x.shape[3], x.shape[2]):          # F.pad: W first, then H
            total = max((-(-n // stride) - 1) * stride + window - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, window, stride)
