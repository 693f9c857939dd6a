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

from dataclasses import dataclass

import torch

from ..kernels import conv2d as _conv2d_mod
from ..kernels import matmul as _mm
from ..kernels import ops
from ..observability import trace
from .cost_model import LayerCost, layer_cost
from .fuse import Epilogue
from .modes import ConvLayer, Dataflow, Stationarity, select_dataflow
from .sparsity import SparsityTag

_NO_EPILOGUE = Epilogue()
_ONE_BY_ONE = (Dataflow.CONV1X1_FEATURE_STATIONARY,
               Dataflow.CONV1X1_WEIGHT_STATIONARY)


@dataclass(frozen=True)
class ConvPlan:
    layer: ConvLayer
    dataflow: Dataflow          # the analytic controller rule's choice
    cost: LayerCost


def plan_conv(x_shape: tuple[int, ...], w_shape: tuple[int, ...],
              stride: int = 1, padding: int = 0,
              name: str = "conv") -> ConvPlan:
    """Controller decision + analytic cost for a conv of the given shapes."""
    _, h, _, cin = x_shape
    fh, _, _, k = w_shape
    layer = ConvLayer(name, IL=h, IC=cin, K=k, FL=fh, S=stride, Z=padding)
    return ConvPlan(layer, select_dataflow(layer), layer_cost(layer))


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
    ``carla_conv`` span carrying both sides of the paper's ledger: the
    dataflow the controller picked with its analytic ``LayerCost``
    (cycles / DRAM bytes / PUF), the epilogue combination that was fused
    (``epilogue=`` attr + ``epilogue_hbm_saved`` bytes), and the measured wall
    time + bytes of the kernel it actually ran (as a child span from
    ``kernels.ops``).
    """
    if w.ndim == 2:
        w = w[None, None]
    ep = epilogue or _NO_EPILOGUE
    plan = plan_conv(tuple(x.shape), tuple(w.shape), stride, padding,
                     name=name)

    if not trace.enabled():
        return _dispatch(x, w, plan, stride, padding, impl, epilogue)

    cost = plan.cost
    if plan.layer.FL == 1:
        rows = _mm.gemm_rows(x, stride)
        tile_util = _mm.tile_util(
            rows, plan.layer.IC, plan.layer.K,
            Stationarity.WEIGHT_STATIONARY.value
            if plan.dataflow == Dataflow.CONV1X1_WEIGHT_STATIONARY
            else Stationarity.ACTIVATION_STATIONARY.value)
    else:
        tile_util = _conv2d_mod.tile_util(x.shape, w.shape, stride, padding)
    sparse_attrs = {}
    if sparsity is not None:
        sparse_attrs = {
            "pruned": True,
            "keep_fraction": sparsity.keep_fraction(plan.layer.IC,
                                                    plan.layer.K),
            "dense_twin_macs": sparsity.dense_twin(plan.layer).macs,
        }
    with trace.span(
            "carla_conv", layer=plan.layer.name,
            dataflow=plan.dataflow.value, epilogue=ep.tag,
            x_shape=list(x.shape), w_shape=list(w.shape),
            stride=stride, padding=padding, batch=int(x.shape[0]),
            macs=cost.macs, dense_macs=plan.layer.dense_macs,
            analytic_cycles=cost.cycles,
            analytic_time_ms=cost.time_s * 1e3,
            analytic_dram_bytes=cost.dram_bytes,
            analytic_puf=cost.puf,
            tuned=False, tile_config="default", tuning_source="analytic",
            tile_util=tile_util,
            effective_dataflow=plan.dataflow.value,
            **sparse_attrs) as sp:
        out = _dispatch(x, w, plan, stride, padding, impl, epilogue)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        # bytes the dispatch actually touched (operands + result); the child
        # kernel span records the same so nested sums stay consistent.  A
        # strided 1x1 only reads the subsampled input view, and fused epilogue
        # operands (scale/bias vectors, residual) are part of the footprint.
        if plan.layer.FL == 1 and stride != 1:
            x_bytes = (_mm.gemm_rows(x, stride) * x.shape[3]
                       * x.element_size())
        else:
            x_bytes = x.numel() * x.element_size()
        sp.attrs["bytes_touched"] = x_bytes + sum(
            a.numel() * a.element_size() for a in (w, out, ep.scale, ep.bias,
                                                   ep.residual)
            if a is not None)
        if ep.n_fused_ops:
            sp.attrs["epilogue_hbm_saved"] = \
                2 * ep.n_fused_ops * out.numel() * out.element_size()
    return out
