"""CARLA public API: reconfigurable convolution with per-layer mode dispatch.

``carla_conv`` is the paper's accelerator as a composable PyTorch op: given
any NHWC convolution, it decides once what runs (``core.autotune.decide``:
the kernel route, a 1x1 GEMM's stationarity by the controller's rule on
the rows or a tuned entry, the tuning entry), routes to that kernel, and
can report the dataflow the paper's controller (``core.modes``) would have
picked and the analytic cost (cycles / DRAM accesses / PUF) the ASIC model
predicts for that layer — so a network built from ``carla_conv`` carries
its own performance model, exactly like the paper's evaluation
methodology.

Passing ``epilogue=Epilogue(scale, bias, relu, residual)`` fuses folded-BN,
the shortcut add, and the activation into the kernel's flush (see
``core.fuse``): the output feature map is written to device memory once
instead of round-tripping once per element-wise op.

A depthwise filter, ``(k, k, 1, C)`` on an x of C channels, runs on a
route of its own (``kernels.dwconv``).  The paper's four dataflows have no
depthwise case and its ASIC model no cost for one, so such a plan names its
dataflow ``depthwise`` and carries no analytic cost (``None``), rather than
a wrong one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import torch

from ..kernels import ops
from ..observability import trace
from . import autotune, cost_model, modes
from .autotune import Decision, TileConfig
from .fuse import Epilogue
from .modes import ConvLayer, Dataflow, Stationarity
from .sparsity import SparsityTag

_NO_EPILOGUE = Epilogue()


@dataclass(frozen=True)
class ConvPlan:
    """A conv's plan: the paper's layer and the dispatch's decision.  The
    paper's side, ``dataflow`` and ``cost``, is worked out when first read,
    so a dispatch that reads neither never runs the ASIC model."""

    layer: ConvLayer
    decision: Decision = field(compare=False)

    @property
    def depthwise(self) -> bool:
        return self.decision.route == autotune.DWCONV

    @cached_property
    def dataflow(self) -> Dataflow:
        """The analytic controller rule's choice (``select_dataflow``);
        ``DEPTHWISE`` for a depthwise conv, which the rule has no case
        for."""
        if self.depthwise:
            return Dataflow.DEPTHWISE
        return modes.select_dataflow(self.layer)

    @cached_property
    def cost(self) -> cost_model.LayerCost | None:
        """The ASIC model's cost; None for a depthwise conv, which it
        cannot cost."""
        if self.depthwise:
            return None
        return cost_model.layer_cost(self.layer)

    @property
    def tile_config(self) -> TileConfig | None:
        """The tuning cache's hit for the layer's shape key (None: a miss
        or tuning disabled); ``tuning_source`` says where it came from."""
        entry = self.decision.entry
        return entry.config if entry is not None else None

    @property
    def tuning_source(self) -> str:
        entry = self.decision.entry
        return entry.source if entry is not None else "analytic"

    @property
    def effective_dataflow(self) -> Dataflow:
        """The dataflow of the kernel the dispatch runs: a 1x1 layer's
        GEMM stationarity (a tuned entry's, else the controller's rule on
        the rows at this batch), the controller's choice for the others."""
        st = self.decision.stationarity
        if st is None:
            return self.dataflow
        return (Dataflow.CONV1X1_WEIGHT_STATIONARY
                if st is Stationarity.WEIGHT_STATIONARY
                else Dataflow.CONV1X1_FEATURE_STATIONARY)


def _decide(x_shape, w_shape, stride, padding, dtype, epilogue_tag):
    """The decision of a conv: a 1x1 filter runs as the GEMM of its (C, K)
    matrix."""
    return autotune.decide(x_shape, w_shape[2:] if w_shape[0] == 1
                           else w_shape, stride, padding, dtype,
                           epilogue_tag)


def plan_conv(x_shape: tuple[int, ...], w_shape: tuple[int, ...],
              stride: int = 1, padding: int = 0, name: str = "conv",
              dtype: str = "float32",
              epilogue_tag: str = "none") -> ConvPlan:
    """Controller decision + analytic cost for a conv of the given shapes.

    The decision is the dispatch's: with the empirical tuning cache enabled
    (``core.autotune``) a hit carries a measured tile and split count —
    and, for 1x1 layers, the measured stationarity (``effective_dataflow``)
    — while ``dataflow``/``cost`` always report the paper's analytic rule
    so the two can be reconciled.
    """
    _, h, _, cin = x_shape
    fh, _, _, k = w_shape
    return ConvPlan(ConvLayer(name, IL=h, IC=cin, K=k, FL=fh, S=stride,
                              Z=padding),
                    _decide(x_shape, w_shape, stride, padding, dtype,
                            epilogue_tag))


def _dispatch(x, w, d: Decision, stride: int, padding: int, impl: str,
              ep: Epilogue):
    if d.route == autotune.DWCONV:
        return ops._dispatch("kernels.dwconv", d, x, w, ep, impl, stride,
                             padding, {"stride": stride, "padding": padding})
    if d.route == autotune.CONV2D:
        # 3x3 serial accumulation and 7x7 row decomposition share the
        # implicit-GEMM conv kernel, which has no 3-tap register limit (the
        # one that forced the ASIC's 21-piece split of the 7x7 stem).
        return ops._dispatch("kernels.conv2d", d, x, w, ep, impl, stride,
                             padding, {"stride": stride, "padding": padding})
    # Both 1x1 modes are the dual-stationarity GEMM.
    return ops._dispatch("kernels.conv1x1", d, x, w[0, 0], ep, impl, stride,
                         0, {"stride": stride})


def carla_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: int = 0, impl: str = "auto",
               epilogue: Epilogue | None = None,
               name: str = "conv",
               sparsity: SparsityTag | None = None) -> torch.Tensor:
    """Reconfigurable convolution: dispatches on the decision of its plan.

    x: (B, H, W, C); w: (FH, FW, C, K) (use (1, 1, C, K) or (C, K) for 1x1;
    (k, k, 1, C) for a depthwise conv, k odd, padding (k - 1) // 2).
    epilogue: optional fused flush (folded-BN scale/bias, residual add, ReLU
    or SiLU) applied on the fp32 accumulator before the single store; the
    depthwise conv's tile sums.
    sparsity: for a structured-pruned layer, the dense twin's channel counts
    (``core.sparsity.SparsityTag``) — the span then records ``keep_fraction``
    and ``dense_twin_macs`` so pruned-vs-dense is measurable per layer.

    With tracing enabled (``observability.trace``) every dispatch records a
    ``carla_conv`` span, the host's time from the call to its return, with a
    ``carla.plan`` child (the decision: route, stationarity, the tuning
    lookup) and the ``kernels.ops`` span of the kernel it ran, which takes
    that decision as it is.  Once the span has closed it is given both
    sides of the paper's ledger: the dataflow the controller picked with
    its analytic ``LayerCost`` (cycles / DRAM bytes / PUF), the epilogue
    combination that was fused (``epilogue=`` attr + ``epilogue_hbm_saved``
    bytes), the bytes the dispatch touched and the plan that ran, the
    kernel span's own.  Nothing waits for the device.
    """
    if w.ndim == 2:
        w = w[None, None]
    ep = epilogue or _NO_EPILOGUE
    if not trace.enabled():
        d = _decide(x.shape, w.shape, stride, padding, ops.dtype_name(x),
                    ep.tag)
        return _dispatch(x, w, d, stride, padding, impl, ep)[0]

    with trace.span("carla_conv") as sp:
        with trace.span("carla.plan"):
            plan = plan_conv(x.shape, w.shape, stride, padding, name=name,
                             dtype=ops.dtype_name(x), epilogue_tag=ep.tag)
        out, launched = _dispatch(x, w, plan.decision, stride, padding, impl,
                                  ep)
    sp.attrs.update(_ledger(x, w, out, plan, launched, ep, stride, padding,
                            sparsity))
    return out


def _ledger(x, w, out, plan: ConvPlan, launched, ep: Epilogue, stride: int,
            padding: int, sparsity: SparsityTag | None) -> dict:
    """The ``carla_conv`` span's attributes: the plan and its analytic cost,
    and ``ops.plan_attrs`` of the dispatch (the bytes it touched, the
    tuning ledger, ``tile_util`` of the plan that launched)."""
    cost = plan.cost
    attrs = ops.plan_attrs(plan.decision, x, w, out, ep, launched,
                           plan.decision.entry, "analytic")
    attrs.update(
        layer=plan.layer.name, dataflow=plan.dataflow.value,
        x_shape=list(x.shape), w_shape=list(w.shape),
        stride=stride, padding=padding, batch=int(x.shape[0]),
        effective_dataflow=plan.effective_dataflow.value)
    if cost is None:
        # a depthwise conv: its multiply-adds from the decision (pads
        # included), no analytic side
        d = plan.decision
        macs = d.rows // max(1, int(x.shape[0])) * d.cols * d.reduction
        attrs.update(macs=macs, dense_macs=macs, analytic_cycles=None,
                     analytic_time_ms=None, analytic_dram_bytes=None,
                     analytic_puf=None)
    else:
        attrs.update(
            macs=cost.macs, dense_macs=plan.layer.dense_macs,
            analytic_cycles=cost.cycles,
            analytic_time_ms=cost.time_s * 1e3,
            analytic_dram_bytes=cost.dram_bytes,
            analytic_puf=cost.puf)
    if sparsity is not None:
        attrs.update(
            pruned=True,
            keep_fraction=sparsity.keep_fraction(plan.layer.IC,
                                                 plan.layer.K),
            dense_twin_macs=sparsity.dense_twin(plan.layer).macs)
    return attrs
