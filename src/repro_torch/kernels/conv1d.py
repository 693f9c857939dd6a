"""Depthwise causal 1-D convolution — the CUDA kernel's wrapper.

``conv1d_causal`` runs ``csrc/conv1d.cu``: ``out[b, t, c] = sum_r
x[b, t-FL+1+r, c] * w[r, c]`` summed in fp32, stored in x's dtype.  x may be a
strided view whose last dimension is contiguous (Mamba2 hands it a column
slice of the in_proj output); w is read as fp32 whatever its dtype, as the
Pallas kernel casts it.  The source's header note says which Pallas kernel it
replaces, what bounds it on the H100 and how its design answers that.

``conv1d_causal_plain`` is the plain PyTorch version of the same function.  A
tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``conv1d_causal.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import conv1d_causal_ref

FLS = (2, 3, 4)     # filter lengths instantiated in csrc/conv1d.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"carla_conv1d_causal": [_I, _P, _P, _P] + [_I] * 7 + [_P]}


def conv1d_causal_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 sum, x's dtype)."""
    return conv1d_causal_ref(x, w).to(x.dtype)


def vector_width(x: torch.Tensor) -> int:
    """Channels per thread: one 16-byte vector when x allows it, else 1."""
    vec = 16 // x.element_size()
    ok = (x.shape[2] % vec == 0 and x.stride(0) % vec == 0
          and x.stride(1) % vec == 0 and x.data_ptr() % 16 == 0)
    return vec if ok else 1


def conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C) with a unit channel stride, w: (FL, C) -> (B, T, C)."""
    b, t, c = x.shape
    fl, c2 = w.shape
    if c != c2:
        raise ValueError(f"conv1d_causal: x has {c} channels, w {c2}")
    if x.device.type == "cpu":
        return conv1d_causal_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv1d_causal: the kernel takes CUDA tensors, x is "
                         f"on {x.device}, w on {w.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"conv1d_causal: dtype {x.dtype} not supported")
    if fl not in FLS:
        raise ValueError(f"conv1d_causal: FL = {fl}, the kernel takes {FLS}")
    if x.stride(2) != 1:
        raise ValueError("conv1d_causal: x's channels must be contiguous")
    if (b - 1) * x.stride(0) + (t - 1) * x.stride(1) + c >= 2 ** 31 or \
            b * t * c >= 2 ** 31:
        raise ValueError("conv1d_causal: offsets past 2**31 elements")
    wf = w.float().contiguous()      # Mamba2's conv_w is fp32 already
    out = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    lib = _build.load("conv1d", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.carla_conv1d_causal(
            _build.DTYPE_CODES[x.dtype], x.data_ptr(), wf.data_ptr(),
            out.data_ptr(), b, t, c, fl, x.stride(0), x.stride(1),
            vector_width(x), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv1d_causal")
    conv1d_causal.launches += 1
    return out


conv1d_causal.launches = 0
