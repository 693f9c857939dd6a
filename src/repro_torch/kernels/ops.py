"""Reconfigurable dispatch over the CUDA kernels, with telemetry spans.

``impl`` selects the execution engine:
  * ``"cuda"`` — the hand-written CUDA kernels (CUDA tensors only);
  * ``"ref"``  — each kernel's plain PyTorch version (``conv2d_plain``,
                 ``matmul_plain``; any device, TF32 off on CUDA);
  * ``"auto"`` — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.
The engine that actually ran is recorded as the ``impl`` span attribute.

What a conv or GEMM runs is decided once, by ``core.autotune.decide``:
the route, a GEMM's stationarity (an explicit one, then the tuning cache's
measured choice, then ``core.modes``' rule on the rows) and the tuning
entry, read once a dispatch when tuning is enabled.  ``carla_conv``
decides in its ``carla.plan`` span and hands the decision to
``_dispatch``; the entry points here decide themselves.  On the ``cuda``
engine ``autotune.launch_plan`` makes the launch's plan, which the launch
and both spans read; the plain versions have no plan, so on the ``ref``
engine no tuned tile applies.

``carla_conv`` hands a depthwise conv (a ``(k, k, 1, C)`` filter) to the
depthwise kernel (``kernels.dwconv``, route ``dwconv``, a
``kernels.dwconv`` span), which has no plan to tune.  ``se_gate`` is the
squeeze-and-excitation gate of an MBConv block (``kernels.se``), from the
tile sums its depthwise conv wrote, and ``se_scale`` the pass that applies
it to the block's depthwise map.

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
operand shapes, FLOPs and ``plan_attrs``: the bytes the operands and
result touch, the fused epilogue and the HBM bytes it saved, the tuning
ledger — ``tuned`` (did a tuned plan run), ``tile_config`` and
``tuning_source`` — and ``tile_util`` (logical FLOPs / FLOPs of the padded
tiles of the plan that launched).  On the ``cuda`` engine the kernel's
wrapper adds a ``kernels.launch`` child around the foreign call, so the
span's self time is the preparation: resolving the engine, the launch
plan, operand checks, workspace, output allocation and the device context
(and, on a direct call, the decision).  When tracing is disabled (the
default) the only cost is one attribute read per call.
"""
from __future__ import annotations

import torch

from ..core import autotune
from ..core.autotune import Decision
from ..core.fuse import Epilogue
from ..core.modes import Stationarity
from ..observability import trace
from . import conv1d as _conv1d_mod
from . import conv2d as _conv2d_mod
from . import dwconv as _dw
from . import matmul as _mm
from . import se as _se

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


def plan_attrs(d: Decision, x, w, out, ep: Epilogue, plan, entry,
               untuned: str = "default") -> dict:
    """The plan's attributes of a dispatch's span, the kernel span's and
    ``carla_conv``'s: the bytes the operands and result touch (a strided
    1x1 reads only its rows of x), the fused epilogue and the HBM bytes it
    saved (each fused element-wise pass would have read and written the
    output), the tuning ledger (``entry`` hit, else ``untuned``) and
    ``tile_util`` of ``plan``, the launch's, or where nothing launched
    ``autotune.reference_plan`` under ``entry``'s tiles."""
    tiles = entry.config if entry is not None else None
    x_elems = x.numel() if d.stationarity is None else d.rows * d.reduction
    attrs = dict(
        bytes_touched=(x_elems * x.element_size()
                       + _nbytes(w, out, ep.scale, ep.bias, ep.residual,
                                 ep.sums)),
        epilogue=ep.tag, tuned=entry is not None,
        tile_config=tiles.short if tiles is not None else "default",
        tuning_source=entry.source if entry is not None else untuned,
        tile_util=autotune.tile_util(
            d, plan or autotune.reference_plan(d, x.shape[-1], tiles)))
    if ep.n_fused_ops:
        attrs["epilogue_hbm_saved"] = 2 * ep.n_fused_ops * _nbytes(out)
    return attrs


def _check_epilogue(d: Decision, w, ep: Epilogue, padding: int) -> None:
    """Raise for what the decision's kernel does not take: tile sums on any
    but the depthwise conv, a residual on it, or another padding than its
    (k - 1) // 2."""
    dw = d.route == autotune.DWCONV
    if ep.sums is not None and not dw:
        raise ValueError("tile sums come from the depthwise conv")
    if dw and (ep.residual is not None or padding != (w.shape[0] - 1) // 2):
        raise ValueError("the depthwise conv takes no residual and pads "
                         f"(k - 1) // 2, got padding {padding}")


def _run(d: Decision, x, w, ep: Epilogue, stride, padding, impl):
    """(output, the plan that launched or None) of decision ``d``."""
    _check_epilogue(d, w, ep, padding)
    kw = dict(scale=ep.scale, bias=ep.bias, relu=ep.relu, silu=ep.silu)
    if d.route == autotune.DWCONV:
        fn = _dw.launch if impl == "cuda" else _dw.dwconv_plain
        return fn(x, w, stride=stride, sums=ep.sums, **kw), None
    kw["residual"] = ep.residual
    conv = d.route == autotune.CONV2D
    if impl != "cuda":
        if conv:
            return _conv2d_mod.conv2d_plain(x, w, stride=stride,
                                            padding=padding, **kw), None
        return _mm.matmul_plain(x, w, stride=stride, **kw), None
    plan = autotune.launch_plan(d, x, w, ep.residual)
    if conv:
        return _conv2d_mod.launch(x, w, plan, stride=stride, padding=padding,
                                  **kw), plan
    return _mm.launch(d.route, x, w, plan, stride=stride, **kw), plan


def _dispatch(name: str, d: Decision, x, w, ep: Epilogue, impl: str,
              stride: int = 1, padding: int = 0, geometry: dict | None = None):
    """(output, launched plan or None) of decision ``d`` on the engine
    ``impl`` resolves to, with a ``name`` span (``geometry`` among its
    attributes) when tracing.  ``carla_conv`` hands its decision in
    here."""
    impl = resolve(impl, x)
    if not trace.enabled():
        return _run(d, x, w, ep, stride, padding, impl)
    with trace.span(name) as sp:
        out, plan = _run(d, x, w, ep, stride, padding, impl)
    sp.attrs.update(
        impl=impl, x_shape=list(x.shape), w_shape=list(w.shape),
        dtype=dtype_name(x), flops=2 * d.rows * d.cols * d.reduction,
        **(geometry or {}),
        **plan_attrs(d, x, w, out, ep, plan,
                     d.entry if impl == "cuda" else None))
    if d.stationarity is not None:
        sp.attrs["stationarity"] = d.stationarity.value
    return out, plan


def conv2d(x, w, *, stride: int = 1, padding: int = 0, impl: str = "auto",
           epilogue: Epilogue | None = None):
    """General NHWC conv; CARLA 3x3/7x7 serial-accumulation dataflow."""
    ep = epilogue or _NO_EPILOGUE
    d = autotune.decide(x.shape, w.shape, stride, padding, dtype_name(x),
                        ep.tag)
    return _dispatch("kernels.conv2d", d, x, w, ep, impl, stride, padding,
                     {"stride": stride, "padding": padding})[0]


def conv1x1(x, w, *, stride: int = 1, impl: str = "auto",
            epilogue: Epilogue | None = None):
    """Pointwise conv via the dual-stationarity GEMM (paper §III.B/C)."""
    ep = epilogue or _NO_EPILOGUE
    d = autotune.decide(x.shape, w.shape, stride, 0, dtype_name(x), ep.tag)
    return _dispatch("kernels.conv1x1", d, x, w, ep, impl, stride, 0,
                     {"stride": stride})[0]


def gemm(x, w, *, impl: str = "auto",
         stationarity: Stationarity | None = None,
         epilogue: Epilogue | None = None):
    """(M, C) @ (C, K) with CARLA stationarity planning."""
    ep = epilogue or _NO_EPILOGUE
    d = autotune.decide(x.shape, w.shape, 1, 0, dtype_name(x), ep.tag,
                        stationarity=stationarity)
    return _dispatch("kernels.gemm", d, x, w, ep, impl)[0]


def se_gate(sums, npix: int, w1, b1, w2, b2, *, impl: str = "auto"):
    """The squeeze-and-excitation gate (B, C) fp32 of a block from the tile
    sums (B, tiles, C) its depthwise conv wrote over ``npix`` pixels; a
    ``kernels.se_gate`` span when tracing."""
    impl = resolve(impl, sums)
    fn = _se.launch if impl == "cuda" else _se.se_gate_plain
    if not trace.enabled():
        return fn(sums, npix, w1, b1, w2, b2)
    with trace.span("kernels.se_gate") as sp:
        out = fn(sums, npix, w1, b1, w2, b2)
    c, r = w1.shape
    sp.attrs.update(impl=impl, sums_shape=list(sums.shape), npix=npix,
                    w1_shape=list(w1.shape), dtype=dtype_name(w1),
                    flops=int(sums.numel() + 4 * sums.shape[0] * c * r),
                    bytes_touched=_nbytes(sums, w1, b1, w2, b2, out))
    return out


def se_scale(x, gate, *, impl: str = "auto"):
    """The squeeze-and-excitation gate (B, C) fp32 applied to the map x
    (B, H, W, C) in a pass of its own (in place on the ``cuda`` engine); a
    ``kernels.se_scale`` span when tracing."""
    impl = resolve(impl, x)
    fn = _se.scale_launch if impl == "cuda" else _se.se_scale_plain
    if not trace.enabled():
        return fn(x, gate)
    with trace.span("kernels.se_scale") as sp:
        out = fn(x, gate)
    sp.attrs.update(impl=impl, x_shape=list(x.shape), dtype=dtype_name(x),
                    flops=int(x.numel()), bytes_touched=_nbytes(x, gate, out))
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
