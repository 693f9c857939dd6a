"""CARLA public API: reconfigurable convolution with per-layer mode dispatch.

``carla_conv`` is the paper's accelerator as a composable PyTorch op: given
any NHWC convolution, it consults the controller (``core.modes``) to pick the
dataflow the ASIC would have used, routes to the corresponding kernel, and can
report the analytic cost (cycles / DRAM accesses / PUF) the ASIC model
predicts for that layer — so a network built from ``carla_conv`` carries its
own performance model, exactly like the paper's evaluation methodology.

Passing ``epilogue=Epilogue(scale, bias, relu, residual)`` fuses folded-BN,
the shortcut add, and the activation into the kernel's flush (see
``core.fuse``): the output feature map is written to device memory once
instead of round-tripping once per element-wise op.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..kernels import matmul as _mm
from ..kernels import ops
from ..observability import trace
from . import autotune
from .autotune import TileConfig
from .cost_model import LayerCost, layer_cost
from .fuse import Epilogue
from .modes import ConvLayer, Dataflow, select_dataflow
from .sparsity import SparsityTag

_NO_EPILOGUE = Epilogue()
_ONE_BY_ONE = (Dataflow.CONV1X1_FEATURE_STATIONARY,
               Dataflow.CONV1X1_WEIGHT_STATIONARY)


@dataclass(frozen=True)
class ConvPlan:
    layer: ConvLayer
    dataflow: Dataflow          # the analytic controller rule's choice
    cost: LayerCost
    # empirical tuning-cache hit for this layer's shape key (None = miss or
    # tuning disabled); ``tuning_source`` says where the plan came from.
    tile_config: TileConfig | None = field(default=None, compare=False)
    tuning_source: str = field(default="analytic", compare=False)

    @property
    def effective_dataflow(self) -> Dataflow:
        """The dataflow the dispatch will actually run: a measured
        stationarity in the tuning cache overrides the analytic 1x1 rule."""
        if (self.layer.FL == 1 and self.tile_config is not None
                and self.tile_config.stationarity):
            if self.tile_config.stationarity == autotune.WS:
                return Dataflow.CONV1X1_WEIGHT_STATIONARY
            return Dataflow.CONV1X1_FEATURE_STATIONARY
        return self.dataflow


def plan_conv(x_shape: tuple[int, ...], w_shape: tuple[int, ...],
              stride: int = 1, padding: int = 0, name: str = "conv",
              dtype: str = "float32",
              epilogue_tag: str = "none") -> ConvPlan:
    """Controller decision + analytic cost for a conv of the given shapes.

    When the empirical tuning cache is enabled (``core.autotune``) the plan
    consults it first: a hit carries a measured tile and split count — and,
    for 1x1 layers, the measured stationarity choice
    (``effective_dataflow``) — while ``dataflow``/``cost`` always report the
    paper's analytic rule so the two can be reconciled.
    """
    b, h, w_sp, cin = x_shape
    fh, fw, _, k = w_shape
    layer = ConvLayer(name, IL=h, IC=cin, K=k, FL=fh, S=stride, Z=padding)
    entry = None
    if autotune.enabled():
        if fh == 1 and fw == 1:
            rows = b * -(-h // stride) * -(-w_sp // stride)
            entry = autotune.lookup_gemm(rows, cin, k, dtype, epilogue_tag)
        else:
            entry = autotune.lookup_conv2d(x_shape, w_shape, stride, padding,
                                           dtype, epilogue_tag)
    return ConvPlan(layer, select_dataflow(layer), layer_cost(layer),
                    tile_config=entry.config if entry is not None else None,
                    tuning_source=(entry.source if entry is not None
                                   else "analytic"))


def _dispatch(x, w, plan: ConvPlan, stride: int, padding: int, impl: str,
              epilogue: Epilogue | None):
    if plan.dataflow in _ONE_BY_ONE:
        # Both 1x1 modes are the dual-stationarity GEMM; ops.conv1x1 picks the
        # residency from the feature count (the same quantity the paper uses).
        return ops.conv1x1(x, w[0, 0], stride=stride, impl=impl,
                           epilogue=epilogue)
    # 3x3 serial accumulation and 7x7 row decomposition share the
    # implicit-GEMM conv kernel, which has no 3-tap register limit (the one
    # that forced the ASIC's 21-piece split of the 7x7 stem).
    return ops.conv2d(x, w, stride=stride, padding=padding, impl=impl,
                      epilogue=epilogue)


def carla_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: int = 0, impl: str = "auto",
               epilogue: Epilogue | None = None,
               name: str = "conv",
               sparsity: SparsityTag | None = None) -> torch.Tensor:
    """Reconfigurable convolution: dispatches on the controller's mode choice.

    x: (B, H, W, C); w: (FH, FW, C, K) (use (1, 1, C, K) or (C, K) for 1x1).
    epilogue: optional fused flush (folded-BN scale/bias, residual add, ReLU)
    applied on the fp32 accumulator before the single store.
    sparsity: for a structured-pruned layer, the dense twin's channel counts
    (``core.sparsity.SparsityTag``) — the span then records ``keep_fraction``
    and ``dense_twin_macs`` so pruned-vs-dense is measurable per layer.

    With tracing enabled (``observability.trace``) every dispatch records a
    ``carla_conv`` span, the host's time from the call to its return, with a
    ``carla.plan`` child (the controller's choice, the cost model and the
    tuning lookup) and the ``kernels.ops`` span of the kernel it ran.  Once
    the span has closed it is given both sides of the paper's ledger: the
    dataflow the controller picked with its analytic ``LayerCost`` (cycles /
    DRAM bytes / PUF), the epilogue combination that was fused
    (``epilogue=`` attr + ``epilogue_hbm_saved`` bytes) and the bytes the
    dispatch touched.  Nothing waits for the device.
    """
    if w.ndim == 2:
        w = w[None, None]
    ep = epilogue or _NO_EPILOGUE
    if not trace.enabled():
        plan = plan_conv(tuple(x.shape), tuple(w.shape), stride, padding,
                         name=name, dtype=ops.dtype_name(x),
                         epilogue_tag=ep.tag)
        return _dispatch(x, w, plan, stride, padding, impl, epilogue)

    with trace.span("carla_conv") as sp:
        with trace.span("carla.plan"):
            plan = plan_conv(tuple(x.shape), tuple(w.shape), stride, padding,
                             name=name, dtype=ops.dtype_name(x),
                             epilogue_tag=ep.tag)
        out = _dispatch(x, w, plan, stride, padding, impl, epilogue)
    sp.attrs.update(_ledger(x, w, out, plan, ep, stride, padding, sparsity))
    return out


def _ledger(x, w, out, plan: ConvPlan, ep: Epilogue, stride: int,
            padding: int, sparsity: SparsityTag | None) -> dict:
    """The ``carla_conv`` span's attributes: the plan and its analytic cost,
    the tuning ledger and the bytes the dispatch touched."""
    cost = plan.cost
    if plan.layer.FL == 1:
        tile_util = autotune.tile_util_gemm(
            _mm.gemm_rows(x, stride), plan.layer.IC, plan.layer.K,
            plan.tile_config,
            stationarity=autotune.WS
            if plan.effective_dataflow == Dataflow.CONV1X1_WEIGHT_STATIONARY
            else autotune.AS)
    else:
        tile_util = autotune.tile_util_conv2d(x.shape, w.shape, stride,
                                              padding, plan.tile_config)
    attrs = dict(
        layer=plan.layer.name, dataflow=plan.dataflow.value, epilogue=ep.tag,
        x_shape=list(x.shape), w_shape=list(w.shape),
        stride=stride, padding=padding, batch=int(x.shape[0]),
        macs=cost.macs, dense_macs=plan.layer.dense_macs,
        analytic_cycles=cost.cycles,
        analytic_time_ms=cost.time_s * 1e3,
        analytic_dram_bytes=cost.dram_bytes,
        analytic_puf=cost.puf,
        tuned=plan.tile_config is not None,
        tile_config=(plan.tile_config.short
                     if plan.tile_config is not None else "default"),
        tuning_source=plan.tuning_source,
        tile_util=tile_util,
        effective_dataflow=plan.effective_dataflow.value)
    if sparsity is not None:
        attrs.update(
            pruned=True,
            keep_fraction=sparsity.keep_fraction(plan.layer.IC,
                                                 plan.layer.K),
            dense_twin_macs=sparsity.dense_twin(plan.layer).macs)
    # bytes the dispatch actually touched (operands + result); the child
    # kernel span records the same so nested sums stay consistent.  A
    # strided 1x1 only reads the subsampled input view, and fused epilogue
    # operands (scale/bias vectors, residual) are part of the footprint.
    if plan.layer.FL == 1 and stride != 1:
        x_bytes = _mm.gemm_rows(x, stride) * x.shape[3] * x.element_size()
    else:
        x_bytes = x.numel() * x.element_size()
    attrs["bytes_touched"] = x_bytes + sum(
        a.numel() * a.element_size() for a in (w, out, ep.scale, ep.bias,
                                               ep.residual)
        if a is not None)
    if ep.n_fused_ops:
        attrs["epilogue_hbm_saved"] = \
            2 * ep.n_fused_ops * out.numel() * out.element_size()
    return attrs
