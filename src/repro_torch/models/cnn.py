"""ResNet-50 and VGG-16 built on ``carla_conv`` — the paper's benchmark CNNs.

Every convolution goes through the CARLA mode dispatcher, so running these
models exercises all four dataflows (7x7 decomposed, 3x3 serial accumulation,
1x1 feature-stationary, 1x1 weight-stationary).  ``network_plan`` returns the
per-layer mode + analytic cost — the exact tables behind the paper's Figs 8-10.

The forwards run **fused by default**: inference-folded BN (scale/bias), ReLU,
and the bottleneck residual add ride the kernels' flush epilogue
(``core.fuse.Epilogue``), so each conv output crosses device memory exactly
once — in particular the shortcut add is fused into the block's last 1x1
conv.  ``fused=False`` runs the same math as separate element-wise ops (the
parity oracle, and the unfused baseline for the bytes-saved ledger).

Activations are NHWC and weights HWIO, as in the JAX package, so parameters
cross between the two through ``models.convert.params_from_numpy`` with no
transposes.  ``width`` scales every channel count for small tests, and the
structured-sparse variant (§IV.A) prunes channels by L1 importance:
``resnet50_prune`` is residual-aware (masks propagate 1x1a -> 3x3 -> 1x1b
through each bottleneck; the shortcut trunk stays dense per Table I), and
``resnet50_apply(..., sparse=True | keep_fractions=...)`` runs the pruned
network through the same fused dispatch path, tagging every pruned dispatch
with its dense twin so telemetry reports keep-fraction and pruned-vs-dense
MACs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.carla import carla_conv, plan_conv
from ..core.fuse import Epilogue
from ..core.sparsity import (
    SparsityTag,
    prune_bn,
    prune_conv_weights,
    topk_channel_mask,
)
from ..pytree import tree_map
from .convert import resolve_device


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _conv_init(g: torch.Generator, fl: int, cin: int, k: int) -> torch.Tensor:
    fan_in = fl * fl * cin
    return torch.randn((fl, fl, cin, k), generator=g) * fan_in ** -0.5


def _bn_init(k: int) -> dict:
    return {"scale": torch.ones(k), "bias": torch.zeros(k)}


def _bn(params, x):
    """Inference-folded batch norm (scale+shift; stats folded into weights)."""
    return x * params["scale"] + params["bias"]


def _conv_bn(x, w, bn, *, fused: bool, relu: bool = False,
             residual=None, stride: int = 1, padding: int = 0,
             impl: str = "auto", name: str = "conv", sparsity=None):
    """conv + folded-BN (+residual) (+ReLU), fused into the kernel flush or
    as the unfused op-by-op sequence (the parity/bytes baseline)."""
    if fused:
        ep = Epilogue(scale=None if bn is None else bn["scale"],
                      bias=None if bn is None else bn["bias"],
                      relu=relu, residual=residual)
        return carla_conv(x, w, stride=stride, padding=padding, impl=impl,
                          epilogue=ep, name=name, sparsity=sparsity)
    y = carla_conv(x, w, stride=stride, padding=padding, impl=impl,
                   name=name, sparsity=sparsity)
    if bn is not None:
        y = _bn(bn, y)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _max_pool(x: torch.Tensor, window: int, stride: int,
              same: bool) -> torch.Tensor:
    """NHWC max-pool, the same windows as ``lax.reduce_window``.

    ``same=True`` pads like XLA's "SAME": the total pad splits low = total//2,
    high = the rest (for the ResNet stem's even 112² input: low 0, high 1),
    with -inf.  ``F.max_pool2d(padding=1)`` would pad both sides and pick
    other windows.
    """
    xc = x.permute(0, 3, 1, 2)                  # NCHW view, no copy
    if same:
        pads = []
        for n in (x.shape[2], x.shape[1]):      # F.pad order: W then H
            total = max((-(-n // stride) - 1) * stride + window - n, 0)
            pads += [total // 2, total - total // 2]
        xc = F.pad(xc, pads, value=-float("inf"))
    y = F.max_pool2d(xc, window, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _head(x: torch.Tensor, fc_w: torch.Tensor) -> torch.Tensor:
    """Global mean then the classifier product, left to plain PyTorch."""
    return x.mean(dim=(1, 2)) @ fc_w.to(x.dtype)


# ------------------------------- ResNet-50 -----------------------------------
RESNET50_BLOCKS = {"conv2": 3, "conv3": 4, "conv4": 6, "conv5": 3}


def resnet50_init(generator: torch.Generator | None = None, *,
                  width: float = 1.0, num_classes: int = 1000,
                  sparse: bool = False, device="cuda") -> dict:
    """Bottleneck ResNet-50; `width` scales all channel counts (smoke tests).

    Weights are drawn on the CPU from ``generator`` (seed 0 when None), then
    moved to ``device``; the default CUDA device raises without a card.
    """
    dev = resolve_device(device)
    g = _generator(generator)
    w = lambda c: max(4, int(c * width))
    h = 0.5 if sparse else 1.0
    params = {"conv1": _conv_init(g, 7, 3, w(64)), "bn1": _bn_init(w(64))}
    groups = [("conv2", 3, w(64), w(64), w(256)),
              ("conv3", 4, w(256), w(128), w(512)),
              ("conv4", 6, w(512), w(256), w(1024)),
              ("conv5", 3, w(1024), w(512), w(2048))]
    for gname, n_blocks, cin, mid, cout in groups:
        midp = max(2, int(mid * h))
        for b in range(n_blocks):
            ic = cin if b == 0 else cout
            blk = {
                "c1": _conv_init(g, 1, ic, midp)[0, 0],
                "bn1": _bn_init(midp),
                "c2": _conv_init(g, 3, midp, midp),
                "bn2": _bn_init(midp),
                "c3": _conv_init(g, 1, midp, cout)[0, 0],
                "bn3": _bn_init(cout),
            }
            if b == 0:
                blk["proj"] = _conv_init(g, 1, ic, cout)[0, 0]
                blk["bnp"] = _bn_init(cout)
            params[f"{gname}_b{b}"] = blk
    params["fc"] = {"w": torch.randn((w(2048), num_classes), generator=g)
                    * w(2048) ** -0.5}
    return tree_map(lambda t: t.contiguous().to(dev), params)


def _group_keep_fraction(keep_fractions, gname: str) -> float:
    """Resolve a scalar or per-group-dict keep_fractions for one group."""
    if isinstance(keep_fractions, dict):
        return float(keep_fractions.get(gname, 1.0))
    return float(keep_fractions)


def resnet50_prune(params, keep_fractions=0.5):
    """Residual-aware structured pruning of a dense ``resnet50_init`` dict.

    Per bottleneck block (paper Table I): the first two convs' output
    channels are pruned by L1 importance, each kept-channel mask propagates
    to the next conv's *input* channels (1x1a -> 3x3 -> 1x1b), and the
    folded-BN scale/bias vectors are pruned alongside their conv so the
    fused epilogue operands stay consistent.  The block-closing 1x1 keeps
    its output channels and the shortcut trunk (conv1, projections, block
    outputs, fc) stays dense, so every residual add still lines up.

    keep_fractions: a scalar applied to every group, or a dict keyed by
    group name (``"conv2"``..``"conv5"``; missing groups stay dense).
    Returns ``(pruned_params, masks)`` with ``masks[f"{g}_b{b}"] = (m1, m2)``
    — the kept-channel masks of the block's first and second conv.
    """
    pruned = dict(params)
    masks: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for gname, nb in RESNET50_BLOCKS.items():
        kf = _group_keep_fraction(keep_fractions, gname)
        for b in range(nb):
            bname = f"{gname}_b{b}"
            blk = params[bname]
            if kf >= 1.0:
                masks[bname] = (np.ones(blk["c1"].shape[-1], bool),
                                np.ones(blk["c2"].shape[-1], bool))
                continue
            m1 = topk_channel_mask(blk["c1"], kf)
            m2 = topk_channel_mask(blk["c2"], kf)
            nblk = dict(blk)
            nblk["c1"] = prune_conv_weights(blk["c1"], m1)
            nblk["bn1"] = prune_bn(blk["bn1"], m1)
            nblk["c2"] = prune_conv_weights(blk["c2"], m2, keep_in=m1)
            nblk["bn2"] = prune_bn(blk["bn2"], m2)
            # block-closing 1x1: input channels follow m2, outputs stay dense
            nblk["c3"] = prune_conv_weights(blk["c3"], keep_in=m2)
            pruned[bname] = nblk
            masks[bname] = (m1, m2)
    return pruned, masks


def resnet50_apply(params, x, *, impl: str = "auto", fused: bool = True,
                   sparse: bool = False, keep_fractions=None):
    """x: (B, H, W, 3) -> (B, num_classes).  All convs via carla_conv.

    fused=True (default): BN + ReLU (+ the bottleneck residual add, fused
    into the last 1x1 conv of each block) ride the kernel flush epilogue.

    sparse=True (or an explicit ``keep_fractions``, scalar or per-group
    dict) runs the structured-sparse variant: ``params`` is pruned via
    ``resnet50_prune`` and the pruned network runs through the same fused
    dispatch path, with every pruned dispatch tagged by its dense twin
    (``SparsityTag``) so traced spans carry keep-fraction / dense-twin MACs.
    A dict that is *already* pruned runs as-is with ``sparse=False`` —
    the forward is shape-polymorphic; the flags exist to prune and to tag.
    """
    if sparse and keep_fractions is None:
        keep_fractions = 0.5
    dense_dims = None
    if keep_fractions is not None:
        dense_dims = {f"{g}_b{b}": {c: tuple(params[f"{g}_b{b}"][c].shape)
                                    for c in ("c1", "c2", "c3")}
                      for g, nb in RESNET50_BLOCKS.items() for b in range(nb)}
        params, _ = resnet50_prune(params, keep_fractions)

    def tag(bname, cname, w):
        if dense_dims is None:
            return None
        ds = dense_dims[bname][cname]
        if ds == tuple(w.shape):
            return None
        return SparsityTag(dense_ic=ds[-2], dense_k=ds[-1])

    x = _conv_bn(x, params["conv1"], params["bn1"], fused=fused, relu=True,
                 stride=2, padding=3, impl=impl, name="conv1")
    x = _max_pool(x, 3, 2, same=True)       # 3x3/2 maxpool
    for gname, nb in RESNET50_BLOCKS.items():
        for b in range(nb):
            bname = f"{gname}_b{b}"
            blk = params[bname]
            stride = 2 if (b == 0 and gname != "conv2") else 1
            sc = x
            if "proj" in blk:
                sc = _conv_bn(x, blk["proj"], blk["bnp"], fused=fused,
                              stride=stride, impl=impl, name=f"{bname}_proj")
            h = _conv_bn(x, blk["c1"], blk["bn1"], fused=fused, relu=True,
                         stride=stride, impl=impl, name=f"{bname}_1x1a",
                         sparsity=tag(bname, "c1", blk["c1"]))
            h = _conv_bn(h, blk["c2"], blk["bn2"], fused=fused, relu=True,
                         padding=1, impl=impl, name=f"{bname}_3x3",
                         sparsity=tag(bname, "c2", blk["c2"]))
            # residual add fused into the block's last 1x1 conv
            x = _conv_bn(h, blk["c3"], blk["bn3"], fused=fused, relu=True,
                         residual=sc, impl=impl, name=f"{bname}_1x1b",
                         sparsity=tag(bname, "c3", blk["c3"]))
    return _head(x, params["fc"]["w"])


# -------------------------------- VGG-16 -------------------------------------
VGG_SPEC = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def vgg16_init(generator: torch.Generator | None = None, *,
               width: float = 1.0, num_classes: int = 1000,
               device="cuda") -> dict:
    dev = resolve_device(device)
    g = _generator(generator)
    w = lambda c: max(4, int(c * width))
    params = {}
    cin = 3
    for gi, (c, n) in enumerate(VGG_SPEC):
        for li in range(n):
            params[f"g{gi}_c{li}"] = _conv_init(g, 3, cin, w(c))
            cin = w(c)
    params["fc"] = {"w": torch.randn((cin, num_classes), generator=g)
                    * cin ** -0.5}
    return tree_map(lambda t: t.contiguous().to(dev), params)


def vgg16_apply(params, x, *, impl: str = "auto", fused: bool = True):
    for gi, (c, n) in enumerate(VGG_SPEC):
        for li in range(n):
            x = _conv_bn(x, params[f"g{gi}_c{li}"], None, fused=fused,
                         relu=True, padding=1, impl=impl)
        x = _max_pool(x, 2, 2, same=False)
    return _head(x, params["fc"]["w"])


def network_plan(layers) -> list:
    """Per-layer CARLA plan table (mode + cycles + DRAM + PUF)."""
    return [plan_conv((1, l.IL, l.IL, l.IC), (l.FL, l.FL, l.IC, l.K),
                      stride=l.S, padding=l.Z, name=l.name) for l in layers]
