"""ResNet v1 (He et al. 2015, arXiv:1512.03385) with inference-folded batch
norm, as the port's ``models/cnn.py`` runs it: the stride of a transition
block on its first 1x1, a projection on every group's first block, BN,
residual add and ReLU fused into each conv's epilogue, and an fc with
no bias.

``layers`` is the benchmark's own table of the forward's work, ``draw`` the
weights in the port's layout (NHWC activations, HWIO weights, 1x1 weights
as (C, K)), ``program`` the port's entry on them.
"""
from __future__ import annotations

import torch

from . import work


def _blocks(cfg: dict):
    """(key, cin, mid, out, stride, first) of every bottleneck in order."""
    cin = cfg["stem_channels"]
    for g in cfg["groups"]:
        for b in range(g["blocks"]):
            yield (f"{g['name']}_b{b}", cin if b == 0 else g["out"], g["mid"],
                   g["out"], g["stride"] if b == 0 else 1, b == 0)
        cin = g["out"]


def layers(cfg: dict, batch: int) -> list[work.Op]:
    item = work.ITEM_BYTES[cfg["dtype"]]
    n, s = batch, cfg["image_size"]
    stem, h, w = work.conv("conv1", n, s, s, cfg["in_channels"],
                           cfg["stem_channels"], cfg["stem_kernel"],
                           cfg["stem_stride"], cfg["stem_pad"], bn=True,
                           residual=False, item=item)
    pool, h, w = work.pool("pool1", n, h, w, cfg["stem_channels"],
                           cfg["pool_window"], cfg["pool_stride"], True, item)
    ops = [stem, pool]
    for key, cin, mid, out, stride, first in _blocks(cfg):
        if first:
            ops.append(work.conv(f"{key}_proj", n, h, w, cin, out, 1, stride,
                                 0, bn=True, residual=False, item=item)[0])
        a, oh, ow = work.conv(f"{key}_1x1a", n, h, w, cin, mid, 1, stride, 0,
                              bn=True, residual=False, item=item)
        b, _, _ = work.conv(f"{key}_3x3", n, oh, ow, mid, mid, 3, 1, 1,
                            bn=True, residual=False, item=item)
        c, _, _ = work.conv(f"{key}_1x1b", n, oh, ow, mid, out, 1, 1, 0,
                            bn=True, residual=True, item=item)
        ops += [a, b, c]
        h, w = oh, ow
    c = cfg["groups"][-1]["out"]
    return ops + [work.mean("mean", n, h, w, c, item),
                  work.fc("fc", n, c, cfg["num_classes"], item)]


def draw(cfg: dict, gen: torch.Generator, device) -> dict:
    """Weights from ``gen`` on ``device``: convs He-scaled (std
    fan_in^-1/2), BN scale and bias drawn, the fc scaled by its width."""
    stem = cfg["stem_kernel"]
    shapes = [((stem, stem, cfg["in_channels"], cfg["stem_channels"]),
               stem * stem * cfg["in_channels"])]
    widths = [cfg["stem_channels"]]
    for _, cin, mid, out, _, first in _blocks(cfg):
        shapes += [((cin, mid), cin), ((3, 3, mid, mid), 9 * mid),
                   ((mid, out), mid)]
        widths += [mid, mid, out]
        if first:
            shapes.append(((cin, out), cin))
            widths.append(out)
    c = cfg["groups"][-1]["out"]
    shapes.append(((c, cfg["num_classes"]), c))
    ws = iter(work.draw_weights(shapes, gen, device))
    bns = iter(work.draw_bn(widths, gen, device))
    params = {"conv1": next(ws), "bn1": next(bns)}
    for key, _, _, _, _, first in _blocks(cfg):
        blk = {}
        for conv, bn in (("c1", "bn1"), ("c2", "bn2"), ("c3", "bn3")) + (
                (("proj", "bnp"),) if first else ()):
            blk[conv], blk[bn] = next(ws), next(bns)
        params[key] = blk
    params["fc"] = {"w": next(ws)}
    return params


def program(cfg: dict):
    """The port's ResNet-50 forward on the default path (``impl="auto"``,
    fused), after checking that it runs this configuration's structure."""
    from repro_torch.models import cnn

    want = [(g["name"], g["blocks"]) for g in cfg["groups"]]
    fixed = {"strides": [g["stride"] for g in cfg["groups"]] == [1, 2, 2, 2],
             "groups": want == list(cnn.RESNET50_BLOCKS.items()),
             "stem": (cfg["stem_stride"], cfg["stem_pad"]) == (2, 3),
             "pool": (cfg["pool_window"], cfg["pool_stride"]) == (3, 2),
             "no fc bias": cfg["fc_bias"] is False}
    if not all(fixed.values()):
        raise ValueError("repro_torch's resnet50_apply cannot run this "
                         f"configuration: {fixed}")

    def forward(params, x):
        return cnn.resnet50_apply(params, x, impl="auto", fused=True)
    return forward
