"""Depthwise causal 1-D convolution — the CUDA kernel's wrapper.

``conv1d_causal`` runs ``csrc/conv1d.cu``: ``out[b, t, c] = sum_r
x[b, t-FL+1+r, c] * w[r, c]`` summed in fp32, stored in x's dtype.  x may be a
strided view whose last dimension is contiguous (Mamba2 hands it a column
slice of the in_proj output); w is read as fp32 whatever its dtype, as the
Pallas kernel casts it.  Any filter length FL >= 1: FL 1-4 run template
instances (``FLS``), any other a kernel that takes FL at run time.  The
source's header note says which Pallas kernel it replaces, what bounds it
on the H100 and how its design answers that.

``conv1d_causal_plain`` is the plain PyTorch version of the same function.  A
tensor on the CPU takes it; a CUDA tensor launches the kernel or raises.
``conv1d_causal.launches`` counts launches.

Gradients: ``conv1d_causal`` is a ``torch.autograd.Function``
(``Conv1dCausal``), so a loss through the kernel trains Mamba2's
``in_proj``/``conv_w`` and RWKV-6's token-shift ``mu``.  Its backward is not
a backward kernel: ``repro`` has none (it trains through its ``jnp`` conv),
so the backward recomputes the plain version under autograd from the saved
x and w and differentiates that.  A Hopper backward kernel is later work.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import conv1d_causal_ref

FLS = (1, 2, 3, 4)  # filter lengths csrc/conv1d.cu instantiates; any other
                    # FL >= 1 runs its runtime-FL kernel

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


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/conv1d.cu (counted)."""
    b, t, c = x.shape
    fl = w.shape[0]
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv1d_causal: the kernel takes CUDA tensors, x is "
                         f"on {x.device}, w on {w.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"conv1d_causal: dtype {x.dtype} not supported")
    if fl < 1:
        raise ValueError(f"conv1d_causal: FL = {fl}, the kernel takes FL >= 1")
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


def conv1d_causal_grads(x, w, g):
    """(dx, dw) of ``conv1d_causal_plain`` for the cotangent g."""
    xg = x.detach().requires_grad_()
    wg = w.detach().requires_grad_()
    with torch.enable_grad():
        out = conv1d_causal_plain(xg, wg)
        return torch.autograd.grad(out, (xg, wg), g)


class Conv1dCausal(torch.autograd.Function):
    """The kernel forward (the plain version on the CPU) with the plain
    backward of ``conv1d_causal_grads``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return conv1d_causal_plain(x, w)
        return _launch(x, w)

    @staticmethod
    def backward(ctx, g):
        return conv1d_causal_grads(*ctx.saved_tensors, g)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C) with a unit channel stride, w: (FL, C) -> (B, T, C).

    Differentiable in x and w (``Conv1dCausal``)."""
    c = x.shape[2]
    if c != w.shape[1]:
        raise ValueError(f"conv1d_causal: x has {c} channels, w "
                         f"{w.shape[1]}")
    return Conv1dCausal.apply(x, w)


conv1d_causal.launches = 0
