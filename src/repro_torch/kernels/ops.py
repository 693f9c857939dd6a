"""Reconfigurable dispatch over the CUDA kernels, with telemetry spans.

``impl`` selects the execution engine:
  * ``"cuda"`` — the hand-written CUDA kernels (CUDA tensors only);
  * ``"ref"``  — each kernel's plain PyTorch version (``conv2d_plain``,
                 ``matmul_plain``; any device, TF32 off on CUDA);
  * ``"auto"`` — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.
The engine that actually ran is recorded as the ``impl`` span attribute.

Mode selection (which stationarity a GEMM uses) is orthogonal to ``impl``
and follows ``core.modes`` — the software twin of CARLA's controller —
unless the empirical tuning cache (``core.autotune``) holds a measured
winner for the layer's shape key, in which case the cached tile, splits
*and* stationarity are used instead.  The lookup is gated on
``autotune.enabled()`` (one attribute read, so the disabled path costs
nothing), is made only on the ``cuda`` engine (the plain versions have no
plan), and is an O(1) dict hit.

``conv1d_causal`` is Mamba2's short depthwise conv (no epilogue, no tiling
ledger: its span carries the same attributes as ``repro``'s).  The attention
kernels have no dispatch here, as in ``repro``: the models call their
wrappers directly.

``conv2d``/``conv1x1``/``gemm`` accept an ``epilogue=`` (``core.fuse.Epilogue``):
folded-BN scale/bias, residual add, and ReLU are applied inside the kernel's
flush, so the output feature map is written to device memory exactly once.

Every entry point is telemetry-instrumented: when the global tracer is
enabled (``observability.trace``), the dispatch records a span timing the
host from the call to its return (nothing waits for the device; the
device's time is the device trace's), and, once the span has closed, its
operand shapes, FLOPs, the bytes the operands and result touch, the fused
epilogue and the HBM bytes it saved, the tuning ledger — ``tuned`` (did the
cache hit), ``tile_config`` and ``tuning_source`` (what ran and why) — and
``tile_util`` (logical FLOPs / FLOPs of the padded tiles the kernel runs).
On the ``cuda`` engine the kernel's wrapper adds a ``kernels.launch`` child
around the foreign call, so the span's self time is the preparation:
resolving the engine, the tuning lookup, operand checks, the tile plan,
workspace, output allocation and the device context.  When tracing is
disabled (the default) the only cost is one attribute read per call.
"""
from __future__ import annotations

import torch

from ..core import autotune
from ..core.autotune import TileConfig
from ..core.fuse import Epilogue
from ..core.modes import Stationarity, select_stationarity
from ..observability import trace
from . import conv1d as _conv1d_mod
from . import conv2d as _conv2d_mod
from . import matmul as _mm

_NO_EPILOGUE = Epilogue()
IMPLS = ("auto", "cuda", "ref")


def resolve(impl: str, x: torch.Tensor) -> str:
    """Resolve ``auto`` to the engine for x's device; check the others."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "ref"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, x is on {x.device}")
    return impl


def dtype_name(t: torch.Tensor) -> str:
    """``float32``/``bfloat16``: the same spelling as the JAX package."""
    return str(t.dtype).removeprefix("torch.")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _epilogue_attrs(sp, ep: Epilogue, out: torch.Tensor) -> None:
    """Record the fused-epilogue ledger on a kernel/dispatch span."""
    sp.attrs["epilogue"] = ep.tag
    if ep.n_fused_ops:
        # Each fused element-wise pass would have read+written the full
        # output feature map through HBM; the fused flush does neither.
        sp.attrs["epilogue_hbm_saved"] = 2 * ep.n_fused_ops * _nbytes(out)


def _lookup(kind: str, key_args, impl: str):
    """Tuning-cache probe: O(1) dict hit, only on the cuda engine."""
    if not autotune.enabled() or impl != "cuda":
        return None
    if kind == "conv2d":
        return autotune.lookup_conv2d(*key_args)
    return autotune.lookup_gemm(*key_args)


def _tuning_attrs(sp, entry, tiles: TileConfig | None) -> None:
    """Record what the tuning cache contributed to this dispatch."""
    sp.attrs["tuned"] = entry is not None
    sp.attrs["tile_config"] = tiles.short if tiles is not None else "default"
    sp.attrs["tuning_source"] = entry.source if entry is not None else "default"


def _conv2d(x, w, ep: Epilogue, stride, padding, impl, tiles):
    kw = dict(stride=stride, padding=padding, scale=ep.scale, bias=ep.bias,
              relu=ep.relu, residual=ep.residual)
    if impl == "cuda":
        return _conv2d_mod.conv2d(x, w, tiles=tiles, **kw)
    return _conv2d_mod.conv2d_plain(x, w, **kw)


def _conv2d_call(x, w, ep: Epilogue, stride, padding, impl):
    """(output, engine, tuning entry, tiles) of one conv2d dispatch."""
    impl = resolve(impl, x)
    entry = _lookup("conv2d", (x.shape, w.shape, stride, padding,
                               dtype_name(x), ep.tag), impl)
    tiles = entry.config if entry is not None else None
    return _conv2d(x, w, ep, stride, padding, impl, tiles), impl, entry, tiles


def conv2d(x, w, *, stride: int = 1, padding: int = 0, impl: str = "auto",
           epilogue: Epilogue | None = None):
    """General NHWC conv; CARLA 3x3/7x7 serial-accumulation dataflow."""
    ep = epilogue or _NO_EPILOGUE
    if not trace.enabled():
        return _conv2d_call(x, w, ep, stride, padding, impl)[0]
    with trace.span("kernels.conv2d") as sp:
        out, impl, entry, tiles = _conv2d_call(x, w, ep, stride, padding,
                                               impl)
    fh, fw, _, k = w.shape
    b, oh, ow, _ = out.shape
    sp.attrs.update(
        impl=impl, x_shape=list(x.shape), w_shape=list(w.shape),
        stride=stride, padding=padding, dtype=dtype_name(x),
        flops=2 * b * oh * ow * k * fh * fw * x.shape[-1],
        bytes_touched=_nbytes(x, w, out, ep.scale, ep.bias, ep.residual),
        tile_util=autotune.tile_util_conv2d(x.shape, w.shape, stride,
                                            padding, tiles))
    _tuning_attrs(sp, entry, tiles)
    _epilogue_attrs(sp, ep, out)
    return out


def _gemm(x, w, ep: Epilogue, stride, st: Stationarity, impl, tiles):
    """x: (M, C), or NHWC read at stride (a 1x1 conv)."""
    kw = dict(scale=ep.scale, bias=ep.bias, relu=ep.relu, residual=ep.residual)
    if impl == "cuda":
        return _mm.matmul(x, w, stride=stride, stationarity=st, tiles=tiles,
                          **kw)
    return _mm.matmul_plain(x, w, stride=stride, **kw)


def _gemm_stationarity(rows: int, tiles: TileConfig | None,
                       stationarity: Stationarity | None = None
                       ) -> Stationarity:
    """The dataflow of a GEMM: an explicit ``stationarity``, then the
    tuning cache's measured choice, then the controller's rule."""
    if stationarity is not None:
        return stationarity
    if tiles is not None and tiles.stationarity:
        return Stationarity(tiles.stationarity)
    return select_stationarity(rows)


def _gemm_call(x, w, ep: Epilogue, stride, impl, rows,
               stationarity: Stationarity | None = None):
    """(output, engine, tuning entry, tiles, stationarity) of one GEMM
    dispatch of ``rows`` rows (x read at ``stride``)."""
    impl = resolve(impl, x)
    entry = _lookup("gemm", (rows, x.shape[-1], w.shape[-1], dtype_name(x),
                             ep.tag), impl)
    tiles = entry.config if entry is not None else None
    st = _gemm_stationarity(rows, tiles, stationarity)
    return _gemm(x, w, ep, stride, st, impl, tiles), impl, entry, tiles, st


def _gemm_attrs(sp, x, w, out, ep: Epilogue, rows: int, impl, entry, tiles,
                st: Stationarity) -> None:
    c, k = x.shape[-1], w.shape[-1]
    # A strided 1x1 reads only the subsampled view of the input — count
    # those rows, not the full fmap.
    sp.attrs.update(
        impl=impl, x_shape=list(x.shape), w_shape=list(w.shape),
        stationarity=st.value, dtype=dtype_name(x), flops=2 * rows * c * k,
        bytes_touched=(rows * c * x.element_size()
                       + _nbytes(w, out, ep.scale, ep.bias, ep.residual)),
        tile_util=autotune.tile_util_gemm(rows, c, k, tiles, st.value))
    _tuning_attrs(sp, entry, tiles)
    _epilogue_attrs(sp, ep, out)


def conv1x1(x, w, *, stride: int = 1, impl: str = "auto",
            epilogue: Epilogue | None = None):
    """Pointwise conv via the dual-stationarity GEMM (paper §III.B/C)."""
    ep = epilogue or _NO_EPILOGUE
    rows = _mm.gemm_rows(x, stride)      # x[:, ::s, ::s] row count
    if not trace.enabled():
        return _gemm_call(x, w, ep, stride, impl, rows)[0]
    with trace.span("kernels.conv1x1") as sp:
        out, *plan = _gemm_call(x, w, ep, stride, impl, rows)
    sp.attrs["stride"] = stride
    _gemm_attrs(sp, x, w, out, ep, rows, *plan)
    return out


def gemm(x, w, *, impl: str = "auto",
         stationarity: Stationarity | None = None,
         epilogue: Epilogue | None = None):
    """(M, C) @ (C, K) with CARLA stationarity planning."""
    ep = epilogue or _NO_EPILOGUE
    if not trace.enabled():
        return _gemm_call(x, w, ep, 1, impl, x.shape[0], stationarity)[0]
    with trace.span("kernels.gemm") as sp:
        out, *plan = _gemm_call(x, w, ep, 1, impl, x.shape[0], stationarity)
    _gemm_attrs(sp, x, w, out, ep, x.shape[0], *plan)
    return out


def _conv1d(x, w, impl):
    if impl == "cuda":
        return _conv1d_mod.conv1d_causal(x, w)
    return _conv1d_mod.conv1d_causal_plain(x, w)


def conv1d_causal(x, w, *, impl: str = "auto"):
    """Depthwise causal conv1d (Mamba2 short conv / RWKV token shift)."""
    impl = resolve(impl, x)
    if not trace.enabled():
        return _conv1d(x, w, impl)
    with trace.span("kernels.conv1d_causal") as sp:
        out = _conv1d(x, w, impl)
    sp.attrs.update(impl=impl, x_shape=list(x.shape), w_shape=list(w.shape),
                    dtype=dtype_name(x), flops=2 * x.numel() * w.shape[0],
                    bytes_touched=_nbytes(x, w, out))
    return out
