"""The squeeze-and-excitation gate of an MBConv block — the CUDA kernel's
wrapper.

``se_gate`` runs ``csrc/se.cu``: from the fp32 tile sums ``(B, tiles, C)``
that the block's depthwise conv wrote beside its map of ``npix`` pixels
(``kernels.dwconv``), ``gate = sigmoid(SiLU(mean @ w1 + b1) @ w2 + b2)``,
fp32 ``(B, C)``, with ``mean = sums.sum(1) / npix``, ``w1`` (C, R), ``w2``
(R, C) in the weights' dtype and fp32 biases.  One launch a block, a
cluster of ``CLUSTER`` blocks an image, each owning a slice of the
channels; every sum in a fixed order (the first fc's as partial sums of
each slice, added in the slices' order).  The source's header note says
why the kernel exists, what bounds it and how its design answers that.
``stages`` chooses its instance from C, R and the dtype: the staged one,
whose blocks hold their slices of ``w1`` and ``w2`` in shared memory, copied
there while the depthwise conv before it runs, wherever they fit the
card's opt-in limit (every gate of EfficientNetV2-S); otherwise the same
algorithm reads the weights from memory.

``se_scale`` applies the gate to the map in a pass of its own (the same
source), ``x[b, p, c] * gate[b, c]`` rounded to x's type, in place by
default; the block's projection then reads the gated map.

``se_gate_plain`` and ``se_scale_plain`` are the plain PyTorch versions of
the same functions.  A tensor on the CPU takes them; a CUDA tensor launches
the kernels or raises.  ``se_gate.launches`` and ``se_scale.launches``
count launches, ``se_gate.staged_launches`` the gate's launches of the
staged instance.  Forward only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import se_gate_ref, se_scale_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"carla_se_gate": [_I] + [_P] * 6 + [_I] * 6 + [_P],
               "carla_se_smem_limit": [_I, _P],
               "carla_se_scale": [_I] + [_P] * 3 + [_I] * 3 + [_P]}
CLUSTER = 8      # se.cu's SE_CLUSTER: blocks an image
THREADS = 512    # se.cu's SE_THREADS: threads a block


def smem_bytes(c: int, r: int, element_size: int, staged: bool) -> int:
    """A gate block's dynamic shared memory in bytes, as ``se.cu``'s
    ``se_smem`` counts it: fp32 slices of the mean and b2, h's partials, h,
    b1 and the threads' parts, an mbarrier, and, staged, the block's rows of
    w1 and columns of w2 in the weights' dtype."""
    cc = -(-c // CLUSTER)
    a16 = lambda n: -(-n // 16) * 16
    head = a16(4 * (2 * cc + 3 * r + THREADS)) + 16
    return head + 2 * a16(cc * r * element_size) if staged else head


def stages(c: int, r: int, dtype: torch.dtype, limit: int) -> bool:
    """Whether a gate of ``c`` channels and width ``r`` with weights in
    ``dtype`` runs the staged instance: a block's slices of both weights
    fit ``limit`` bytes of shared memory (the card's opt-in limit a
    block) beside the rest."""
    return smem_bytes(c, r, dtype.itemsize, True) <= limit


@functools.cache
def smem_limit(device_index: int) -> int:
    """The opt-in limit of shared memory a block on a CUDA device, in
    bytes."""
    lib = _build.load(_build.ROUTES["se"].lib, _SIGNATURES)
    out = ctypes.c_int()
    _build.check(lib.carla_se_smem_limit(device_index,
                                         ctypes.addressof(out)),
                 "se_gate: shared memory limit")
    return out.value


def se_gate_plain(sums: torch.Tensor, npix: int, w1, b1, w2,
                  b2) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32)."""
    return se_gate_ref(sums, npix, w1, b1, w2, b2)


def _check(sums, npix: int, w1, b1, w2, b2) -> tuple[int, int, int, int]:
    if sums.dim() != 3 or sums.dtype != torch.float32:
        raise ValueError(f"se_gate: sums must be fp32 (B, tiles, C), got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    b, tiles, c = sums.shape
    r = w1.shape[-1]
    want = {"w1": (c, r), "b1": (r,), "w2": (r, c), "b2": (c,)}
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"se_gate: {name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if npix < 1:
        raise ValueError(f"se_gate: npix {npix}")
    return b, tiles, c, r


def se_gate(sums: torch.Tensor, npix: int, w1: torch.Tensor,
            b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor) -> torch.Tensor:
    """sums (B, tiles, C) fp32 of a map of ``npix`` pixels -> the gate
    (B, C) fp32."""
    _check(sums, npix, w1, b1, w2, b2)
    if sums.device.type == "cpu":
        return se_gate_plain(sums, npix, w1, b1, w2, b2)
    return launch(sums, npix, w1, b1, w2, b2)


def launch(sums, npix: int, w1, b1, w2, b2) -> torch.Tensor:
    """Check the operands and launch the kernel."""
    b, tiles, c, r = _check(sums, npix, w1, b1, w2, b2)
    if w1.dtype not in _build.DTYPE_CODES or w2.dtype != w1.dtype:
        raise TypeError(f"se_gate: w1 {w1.dtype}, w2 {w2.dtype}")
    for name, t in (("sums", sums), ("w1", w1), ("w2", w2)):
        if t.device != sums.device or not t.is_contiguous():
            raise ValueError(f"se_gate: {name} must be contiguous on "
                             f"{sums.device}")
    b1, b2 = (v.to(sums.device, torch.float32).contiguous()
              for v in (b1, b2))
    route = _build.ROUTES["se"]
    lib = _build.load(route.lib, _SIGNATURES)
    staged = stages(c, r, w1.dtype, smem_limit(sums.device.index))
    gate = torch.empty((b, c), dtype=torch.float32, device=sums.device)
    with torch.cuda.device(sums.device):
        _build.launch(getattr(lib, route.entry), (
            _build.DTYPE_CODES[w1.dtype], sums.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gate.data_ptr(), b,
            tiles, npix, c, r, int(staged),
            torch.cuda.current_stream().cuda_stream), "se_gate", "se")
    se_gate.launches += 1
    se_gate.staged_launches += staged
    return gate


se_gate.launches = 0
se_gate.staged_launches = 0


def se_scale_plain(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The gate pass in plain PyTorch: a new tensor."""
    return se_scale_ref(x, gate)


def _check_scale(x, gate) -> tuple[int, int, int]:
    if x.dim() != 4 or gate.dtype != torch.float32 \
            or tuple(gate.shape) != (x.shape[0], x.shape[-1]):
        raise ValueError(f"se_scale: x must be (B, H, W, C) and gate fp32 "
                         f"(B, C), got {tuple(x.shape)} and {gate.dtype} "
                         f"{tuple(gate.shape)}")
    b, h, w, c = x.shape
    return b, h * w, c


def se_scale(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) times gate (B, C) fp32 by image and channel."""
    _check_scale(x, gate)
    if x.device.type == "cpu":
        return se_scale_plain(x, gate)
    return scale_launch(x, gate)


def scale_launch(x, gate, out=None) -> torch.Tensor:
    """Check the operands and launch the gate pass into ``out`` (x itself
    when None)."""
    b, npix, c = _check_scale(x, gate)
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"se_scale: dtype {x.dtype}")
    out = x if out is None else out
    for name, t in (("x", x), ("gate", gate), ("out", out)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"se_scale: {name} must be contiguous on "
                             f"{x.device}")
    if out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError(f"se_scale: out {out.dtype} {tuple(out.shape)}")
    route = _build.ROUTES["se_scale"]
    lib = _build.load(route.lib, _SIGNATURES)
    with torch.cuda.device(x.device):
        _build.launch(getattr(lib, route.entry), (
            _build.DTYPE_CODES[x.dtype], x.data_ptr(), gate.data_ptr(),
            out.data_ptr(), b, npix, c,
            torch.cuda.current_stream().cuda_stream), "se_scale",
            "se_scale")
    se_scale.launches += 1
    return out


se_scale.launches = 0
