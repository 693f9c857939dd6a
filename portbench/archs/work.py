"""The work of a forward, counted from its shapes, and weights drawn from a
seed.

An ``Op`` is one operation of a forward at the cell's batch: the
operations the chip has to do and the bytes it has to move, each input
read once and each output written once, whatever a kernel reads again.
Nothing here looks at what the program launches: a kernel that is
replaced, fused or captured in a graph changes only the time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

ITEM_BYTES = {"float32": 4, "bfloat16": 2}
EPILOGUE_BYTES = 4            # folded-BN scale and bias stay fp32
ALIGN = 64                    # elements: every weight starts 256-byte aligned


@dataclass(frozen=True)
class Op:
    name: str
    kind: str                 # conv, pool, mean, fc
    flops: int                # what the function needs: a multiply-add
                              # counts 2, a max or an add 1, and a tap
                              # that lands on a pad counts nothing
    model_flops: int          # 2 x the multiply-adds of the convs and the
                              # fc, pads included (published FLOPs)
    bytes: int
    macs: int = 0             # multiply-adds, pads included


def taps(size: int, out: int, fl: int, stride: int, pad: int) -> int:
    """Along one axis: the (output, tap) pairs whose input position, out *
    stride - pad + tap, lies inside [0, size)."""
    return sum(max(0, min(fl, size + pad - o * stride)
                   - max(0, pad - o * stride)) for o in range(out))


def conv(name: str, n: int, h: int, w: int, cin: int, k: int, fl: int,
         stride: int, pad: int, *, bn: bool, residual: bool,
         item: int) -> tuple[Op, int, int]:
    """A convolution with its fused epilogue; returns (op, oh, ow).

    ``macs`` and ``model_flops`` count FL^2 a channel for every output
    position, pads included (the convention of published FLOPs); ``flops``
    counts only the taps that land inside the input.  A strided 1x1 reads
    only the rows it samples.
    """
    oh = (h + 2 * pad - fl) // stride + 1
    ow = (w + 2 * pad - fl) // stride + 1
    macs = n * oh * ow * k * fl * fl * cin
    inside = (n * k * cin * taps(h, oh, fl, stride, pad)
              * taps(w, ow, fl, stride, pad))
    x_elems = n * oh * ow * cin if fl == 1 else n * h * w * cin
    out = n * oh * ow * k
    nbytes = item * (x_elems + fl * fl * cin * k + out
                     + (out if residual else 0))
    nbytes += EPILOGUE_BYTES * 2 * k if bn else 0
    return Op(name, "conv", 2 * inside, 2 * macs, nbytes, macs), oh, ow


def pool(name: str, n: int, h: int, w: int, c: int, window: int, stride: int,
         same: bool, item: int) -> tuple[Op, int, int]:
    """A max-pool; ``same`` gives ceil(n / stride) positions (XLA's SAME,
    the odd pad high).  Each output takes one max fewer than its window
    holds inside the input."""
    if same:
        oh, ow = -(-h // stride), -(-w // stride)
        ph = max((oh - 1) * stride + window - h, 0) // 2
        pw = max((ow - 1) * stride + window - w, 0) // 2
    else:
        oh, ow = (h - window) // stride + 1, (w - window) // stride + 1
        ph = pw = 0
    flops = n * c * (taps(h, oh, window, stride, ph)
                     * taps(w, ow, window, stride, pw) - oh * ow)
    return (Op(name, "pool", flops, 0, item * n * c * (h * w + oh * ow)),
            oh, ow)


def mean(name: str, n: int, h: int, w: int, c: int, item: int) -> Op:
    return Op(name, "mean", n * h * w * c, 0, item * n * c * (h * w + 1))


def fc(name: str, n: int, c: int, k: int, item: int) -> Op:
    macs = n * c * k
    return Op(name, "fc", 2 * macs, 2 * macs, item * (n * c + c * k + n * k),
              macs)


def least_seconds(ops: list[Op], flops_per_s: float,
                  bytes_per_s: float) -> float:
    """The least time the chip could take: each op bound by its operations
    or its bytes, whichever takes longer."""
    return sum(max(o.flops / flops_per_s, o.bytes / bytes_per_s)
               for o in ops)


def draw_weights(shapes: list[tuple], gen: torch.Generator,
                 device) -> list[torch.Tensor]:
    """He-scaled normal weights, one (shape, fan_in) each, from one draw on
    ``device``: views of one buffer, each 256-byte aligned."""
    sizes = [math.prod(s) for s, _ in shapes]
    starts, total = [], 0
    for size in sizes:
        starts.append(total)
        total += -(-size // ALIGN) * ALIGN
    buf = torch.randn(total, generator=gen, device=device)
    return [buf[a:a + size].view(shape).mul_(fan_in ** -0.5)
            for a, size, (shape, fan_in) in zip(starts, sizes, shapes)]


def draw_bn(widths: list[int], gen: torch.Generator,
            device) -> list[dict]:
    """Folded batch norm that changes the math: scale in [0.5, 1.5), bias
    in [-0.5, 0.5), from one draw."""
    s = sum(widths)
    u = torch.rand(2 * s, generator=gen, device=device)
    u[:s].add_(0.5)
    u[s:].sub_(0.5)
    out, a = [], 0
    for k in widths:
        out.append({"scale": u[a:a + k], "bias": u[s + a:s + a + k]})
        a += k
    return out
