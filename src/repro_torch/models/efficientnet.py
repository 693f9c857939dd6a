"""EfficientNetV2-S (Tan and Le, ICML 2021, arXiv:2104.00298, Table 4) built
on ``carla_conv``.

The stages, as ``v2_s_block`` in google/automl's
``efficientnetv2/effnetv2_configs.py`` gives them (``EFFNETV2_S``):

    stage  block         kernel  stride  expand  out  layers  SE
    0      conv          3x3     2       -       24   1       -
    1      Fused-MBConv  3x3     1       1       24   2       -
    2      Fused-MBConv  3x3     2       4       48   4       -
    3      Fused-MBConv  3x3     2       4       64   4       -
    4      MBConv        3x3 dw  2       4       128  6       0.25
    5      MBConv        3x3 dw  1       6       160  9       0.25
    6      MBConv        3x3 dw  2       6       256  15      0.25
    7      conv 1x1, mean, fc    -       -       1280 1       -

A stride applies to a stage's first layer; every conv is followed by BN,
folded into a scale and a bias; the activation is SiLU.  Per block:

* MBConv: ``e1 = SiLU(bn(conv1x1(x)))`` to ``expand * C_in`` channels; ``d =
  SiLU(bn(dwconv3x3(e1, stride)))``; the squeeze-and-excitation gate ``g =
  sigmoid(W2 SiLU(W1 mean_hw(d) + b1) + b2)``, W1 reducing to ``int(0.25 *
  C_in)``; ``y = bn(conv1x1(d * g))``, plus x where the stride is 1 and
  ``C_in == C_out``.
* Fused-MBConv, expand 4: ``y = bn(conv1x1(SiLU(bn(conv3x3(x, stride)))))``,
  plus x where the block keeps its shape; expand 1: ``y =
  SiLU(bn(conv3x3(x, stride))) + x``.
* Head: ``fc(mean_hw(SiLU(bn(conv1x1(x, 256 -> 1280)))))``, the fc with a
  bias.

Padding is symmetric, ``(k - 1) // 2`` (torchvision's ``efficientnet_v2_s``;
the TF reference pads SAME, asymmetrically at stride 2: the same shapes and
work, other windows).  Dropout and stochastic depth are off at inference.

The forward runs **fused** by default: BN, SiLU and the shortcut ride the
kernels' flush (``core.fuse.Epilogue``, SiLU before the shortcut); each
depthwise conv (``carla_conv`` on its ``(3, 3, 1, C)`` filter, the
``dwconv`` route) writes, besides its map, the per-tile channel sums its
block's SE mean reads; the SE gate is one kernel a block (``kernels.ops.
se_gate``) and a pass of its own scales the depthwise map by it in place
(``kernels.ops.se_scale``), both under a ``cnn.se`` span when tracing; the
projection reads the gated map.  (Scaling the map where the projection's
GEMM reads it, so that the gated map is never written, made the replay
slower on the H100: ``PERF.md``.)  ``fused=False`` runs the same math op
by op.  Like ``cnn.resnet50_apply`` it goes through ``cnn._forward``: on the
card a fused call of at most ``cnn_graph.GRAPH_MAX_BATCH`` images with
tracing off is replayed from one CUDA graph, counted on
``efficientnetv2_s_apply``.

Activations are NHWC, weights HWIO ((C, K) for a 1x1, ``(k, k, 1, C)``
for a depthwise conv); ``width`` scales every channel count for small
tests.
"""
from __future__ import annotations

import torch

from ..kernels import dwconv as _dw
from ..kernels import ops
from ..observability import trace
from ..pytree import tree_map
from . import cnn, cnn_graph
from .convert import resolve_device

# (block, layers, kernel, stride, expand, out channels, SE ratio)
EFFNETV2_S = (
    ("fused", 2, 3, 1, 1, 24, 0.0),
    ("fused", 4, 3, 2, 4, 48, 0.0),
    ("fused", 4, 3, 2, 4, 64, 0.0),
    ("mbconv", 6, 3, 2, 4, 128, 0.25),
    ("mbconv", 9, 3, 1, 6, 160, 0.25),
    ("mbconv", 15, 3, 2, 6, 256, 0.25),
)
STEM, HEAD = 24, 1280


def blocks(width: float = 1.0):
    """(key, block, cin, expanded, cout, kernel, stride, SE width) of every
    block in order, at ``width``."""
    w = lambda c: max(4, int(c * width))
    cin = w(STEM)
    for si, (kind, n, k, stride, expand, out, se) in enumerate(EFFNETV2_S):
        for b in range(n):
            c = cin if b == 0 else w(out)
            yield (f"s{si + 1}_b{b}", kind, c, c * expand, w(out), k,
                   stride if b == 0 else 1, max(1, int(se * c)) if se else 0)
        cin = w(out)


def efficientnetv2_s_init(generator: torch.Generator | None = None, *,
                          width: float = 1.0, num_classes: int = 1000,
                          device="cuda") -> dict:
    """EfficientNetV2-S's weights, He-scaled, BN folded to scale 1 and bias
    0, the SE and fc biases 0; ``width`` scales the channels (CPU tests).

    Drawn on the CPU from ``generator`` (seed 0 when None), then moved to
    ``device``; the default CUDA device raises without a card."""
    dev = resolve_device(device)
    g = cnn._generator(generator)
    conv, bn = cnn._conv_init, cnn._bn_init
    stem = max(4, int(STEM * width))
    params = {"stem": {"w": conv(g, 3, 3, stem), "bn": bn(stem)}}
    for key, kind, cin, cexp, cout, k, _, se in blocks(width):
        if kind == "fused" and cexp == cin:
            params[key] = {"conv": conv(g, k, cin, cout), "bn": bn(cout)}
        elif kind == "fused":
            params[key] = {"expand": conv(g, k, cin, cexp), "bn1": bn(cexp),
                           "project": conv(g, 1, cexp, cout)[0, 0],
                           "bn2": bn(cout)}
        else:
            dw = torch.randn((k, k, 1, cexp), generator=g) * k ** -1.0
            params[key] = {
                "expand": conv(g, 1, cin, cexp)[0, 0], "bn1": bn(cexp),
                "dw": dw, "bn2": bn(cexp),
                "se": {"w1": conv(g, 1, cexp, se)[0, 0],
                       "b1": torch.zeros(se),
                       "w2": conv(g, 1, se, cexp)[0, 0],
                       "b2": torch.zeros(cexp)},
                "project": conv(g, 1, cexp, cout)[0, 0], "bn3": bn(cout)}
    last = params[key]["project" if "project" in params[key]
                       else "conv"].shape[-1]
    head = max(4, int(HEAD * width))
    params["head"] = {"w": conv(g, 1, last, head)[0, 0], "bn": bn(head)}
    params["fc"] = {"w": torch.randn((head, num_classes), generator=g)
                    * head ** -0.5, "b": torch.zeros(num_classes)}
    return tree_map(lambda t: t.contiguous().to(dev), params)


def efficientnetv2_s_apply(params, x, *, impl: str = "auto",
                           fused: bool = True):
    """x: (B, H, W, 3) -> (B, num_classes).  Every conv via carla_conv.

    fused=True (default): BN, SiLU and the shortcut ride the kernels'
    flush, each block's SE gate is one kernel from its depthwise conv's tile
    sums and one pass applies it to the depthwise map.
    fused=False runs the same math op by op.  Replayed from a CUDA graph as
    ``cnn.resnet50_apply`` is (the module's docstring), its counters on
    ``efficientnetv2_s_apply``."""
    return cnn._forward(efficientnetv2_s_apply, lambda x: _efficientnet(
        params, x, impl=impl, fused=fused), params, x, impl=impl,
        fused=fused)


def _se(p: dict, d: torch.Tensor, sums: torch.Tensor, impl: str,
        name: str) -> torch.Tensor:
    """The depthwise map d times its squeeze-and-excitation gate: the gate
    (B, C) fp32 from the depthwise conv's tile sums, then the pass that
    applies it (in place on the card); a ``cnn.se`` span (``layer``) when
    tracing."""
    def run():
        gate = ops.se_gate(sums, d.shape[1] * d.shape[2], p["w1"], p["b1"],
                           p["w2"], p["b2"], impl=impl)
        return ops.se_scale(d, gate, impl=impl)
    if not trace.enabled():
        return run()
    with trace.span("cnn.se", layer=name):
        return run()


def _se_unfused(p: dict, d: torch.Tensor) -> torch.Tensor:
    """The gate op by op, from the map itself."""
    mean = d.float().mean(dim=(1, 2))
    h = torch.nn.functional.silu(mean @ p["w1"].float() + p["b1"].float())
    return torch.sigmoid(h @ p["w2"].float() + p["b2"].float())


def _mbconv(blk: dict, x, *, stride: int, residual: bool, impl: str,
            fused: bool, key: str):
    kw = dict(fused=fused, impl=impl)
    h = cnn._conv_bn(x, blk["expand"], blk["bn1"], silu=True,
                     name=f"{key}_expand", **kw)
    k = blk["dw"].shape[0]
    sums = None
    if fused:
        b, oh, ow, c = _dw.out_shape(h.shape, k, stride)
        sums = torch.empty((b, _dw.sum_tiles(oh, ow), c),
                           dtype=torch.float32, device=h.device)
    d = cnn._conv_bn(h, blk["dw"], blk["bn2"], silu=True, stride=stride,
                     padding=(k - 1) // 2, name=f"{key}_dw", sums=sums, **kw)
    if fused:
        d = _se(blk["se"], d, sums, impl, f"{key}_se")
    else:
        d = d * _se_unfused(blk["se"], d)[:, None, None, :].to(d.dtype)
    return cnn._conv_bn(d, blk["project"], blk["bn3"],
                        residual=x if residual else None,
                        name=f"{key}_project", **kw)


def _efficientnet(params, x, *, impl: str, fused: bool):
    kw = dict(fused=fused, impl=impl)
    x = cnn._conv_bn(x, params["stem"]["w"], params["stem"]["bn"],
                     silu=True, stride=2, padding=1, name="stem", **kw)
    for si, (kind, n, k, stride, expand, _, _) in enumerate(EFFNETV2_S):
        for b in range(n):
            key = f"s{si + 1}_b{b}"
            blk = params[key]
            s = stride if b == 0 else 1
            if kind == "mbconv":
                cout = blk["project"].shape[-1]
                x = _mbconv(blk, x, stride=s, residual=s == 1
                            and x.shape[-1] == cout, impl=impl,
                            fused=fused, key=key)
            elif "conv" in blk:
                res = s == 1 and x.shape[-1] == blk["conv"].shape[-1]
                x = cnn._conv_bn(x, blk["conv"], blk["bn"], silu=True,
                                 stride=s, padding=(k - 1) // 2,
                                 residual=x if res else None,
                                 name=f"{key}_conv", **kw)
            else:
                res = s == 1 and x.shape[-1] == blk["project"].shape[-1]
                h = cnn._conv_bn(x, blk["expand"], blk["bn1"], silu=True,
                                 stride=s, padding=(k - 1) // 2,
                                 name=f"{key}_expand", **kw)
                x = cnn._conv_bn(h, blk["project"], blk["bn2"],
                                 residual=x if res else None,
                                 name=f"{key}_project", **kw)
    x = cnn._conv_bn(x, params["head"]["w"], params["head"]["bn"],
                     silu=True, name="head", **kw)
    return cnn._head(x, params["fc"]["w"], params["fc"].get("b"))


cnn_graph.reset(efficientnetv2_s_apply)
