"""Depthwise 2-D convolution — the CUDA kernel's wrapper.

``dwconv`` runs ``csrc/dwconv.cu``: ``out[b, oh, ow, c] = flush(sum_{r, t}
x[b, oh*S - P + r, ow*S - P + t, c] * w[r, t, 0, c])`` for NHWC x and a
``(k, k, 1, C)`` filter, k odd, padding ``P = (k - 1) // 2``, fp32 sums, the
flush (scale -> bias -> ReLU or SiLU) and one store in x's dtype.  Given
``sums``, an fp32 ``(B, sum_tiles(OH, OW), C)`` tensor, it also writes there
each tile of ``TILE_PIX`` output pixels' sum of the flushed values by
channel (the pixels row-major, the last tile short): what a
squeeze-and-excitation mean reads (``kernels.se``).  The source's header
note says why the kernel exists, what bounds it on the H100 and how its
design answers that.

``dwconv_plain`` is the plain PyTorch version of the same function.  A
tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``dwconv.launches`` counts launches.  Forward only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import out_hw
from .ref import dwconv_ref, tile_sums_ref

TILE_PIX = 16                  # csrc/dwconv.cu: DW_TILE_PIX

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"carla_dwconv": [_I] + [_P] * 6 + [_I] * 9 + [_P]}


def sum_tiles(oh: int, ow: int) -> int:
    """Tiles of ``TILE_PIX`` output pixels an image of an (oh, ow) map."""
    return -(-oh * ow // TILE_PIX)


def out_shape(x_shape, k: int, stride: int) -> tuple[int, int, int, int]:
    b, h, w, c = x_shape
    return (b, *out_hw(h, w, k, k, stride, (k - 1) // 2), c)


def dwconv_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 scale=None, bias=None, relu: bool = False,
                 silu: bool = False, sums=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 sums, x's dtype); the
    tiles' sums, of the fp32 values before the rounding to x's dtype, are
    written into ``sums``."""
    y = dwconv_ref(x, w, stride, scale=scale, bias=bias, relu=relu,
                   silu=silu)
    if sums is not None:
        sums.copy_(tile_sums_ref(y, TILE_PIX))
    return y.to(x.dtype)


def _check(x, w, stride: int, sums):
    b, h, wd, c = x.shape
    k = w.shape[0]
    if w.shape != (k, k, 1, c) or k % 2 == 0:
        raise ValueError(f"dwconv: w must be (k, k, 1, {c}) with k odd, "
                         f"got {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"dwconv: stride {stride}")
    shape = out_shape(x.shape, k, stride)
    if sums is not None:
        want = (b, sum_tiles(shape[1], shape[2]), c)
        if (sums.dtype != torch.float32 or tuple(sums.shape) != want
                or not sums.is_contiguous() or sums.device != x.device):
            raise ValueError(f"dwconv: sums must be contiguous fp32 {want} "
                             f"on {x.device}, got {sums.dtype} "
                             f"{tuple(sums.shape)} on {sums.device}")
    return shape


def dwconv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           scale: torch.Tensor | None = None,
           bias: torch.Tensor | None = None, relu: bool = False,
           silu: bool = False, sums: torch.Tensor | None = None
           ) -> torch.Tensor:
    """x: (B, H, W, C), w: (k, k, 1, C) -> (B, OH, OW, C) in x's dtype;
    scale/bias ((C,)) and ReLU or SiLU fused into the flush; ``sums`` (fp32
    (B, sum_tiles(OH, OW), C)) written when given."""
    kw = dict(stride=stride, scale=scale, bias=bias, relu=relu, silu=silu,
              sums=sums)
    if x.device.type == "cpu":
        _check(x, w, stride, sums)
        return dwconv_plain(x, w, **kw)
    return launch(x, w, **kw)


def launch(x, w, *, stride: int = 1, scale=None, bias=None,
           relu: bool = False, silu: bool = False, sums=None
           ) -> torch.Tensor:
    """Check the operands and launch the kernel."""
    if relu and silu:
        raise ValueError("dwconv: ReLU or SiLU, not both")
    shape = _check(x, w, stride, sums)
    b, h, wd, c = x.shape
    code, sc, bi = _build.launch_operands("dwconv", x, w, shape, scale, bias,
                                          None)
    route = _build.ROUTES["dwconv"]
    lib = _build.load(route.lib, _SIGNATURES)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(getattr(lib, route.entry), (
            code, x.data_ptr(), w.data_ptr(), _build.ptr(sc), _build.ptr(bi),
            out.data_ptr(), _build.ptr(sums), b, h, wd, c, w.shape[0],
            stride, shape[1], shape[2], 2 if silu else int(relu),
            torch.cuda.current_stream().cuda_stream), "dwconv", "dwconv")
    dwconv.launches += 1
    return out


dwconv.launches = 0
