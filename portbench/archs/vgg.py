"""VGG (Simonyan and Zisserman 2014, arXiv:1409.1556) as the port's
``models/cnn.py`` runs it: 3x3 convs with no bias and ReLU fused into the
epilogue, a 2x2 max-pool after each group, then a global mean and one fc
with no bias.

``layers`` is the benchmark's own table of the forward's work, ``draw`` the
weights in the port's layout (HWIO), ``program`` the port's entry.
"""
from __future__ import annotations

import torch

from . import work


def _convs(cfg: dict):
    """(key, cin, cout) of every conv, and None after each group."""
    cin = cfg["in_channels"]
    for gi, g in enumerate(cfg["groups"]):
        for li in range(g["convs"]):
            yield f"g{gi}_c{li}", cin, g["channels"]
            cin = g["channels"]
        yield None


def layers(cfg: dict, batch: int) -> list[work.Op]:
    item = work.ITEM_BYTES[cfg["dtype"]]
    n = batch
    h = w = cfg["image_size"]
    fl, pad = cfg["conv_kernel"], cfg["conv_pad"]
    ops, c = [], cfg["in_channels"]
    for i, conv in enumerate(_convs(cfg)):
        if conv is None:
            op, h, w = work.pool(f"pool{i}", n, h, w, c, cfg["pool_window"],
                                 cfg["pool_stride"], False, item)
        else:
            key, cin, c = conv
            op, h, w = work.conv(key, n, h, w, cin, c, fl, 1, pad, bn=False,
                                 residual=False, item=item)
        ops.append(op)
    return ops + [work.mean("mean", n, h, w, c, item),
                  work.fc("fc", n, c, cfg["num_classes"], item)]


def draw(cfg: dict, gen: torch.Generator, device) -> dict:
    """He-scaled conv weights (std fan_in^-1/2) and the fc scaled by its
    width, from ``gen`` on ``device``."""
    fl = cfg["conv_kernel"]
    convs = [c for c in _convs(cfg) if c is not None]
    c = convs[-1][2]
    shapes = [((fl, fl, cin, cout), fl * fl * cin) for _, cin, cout in convs]
    ws = work.draw_weights(shapes + [((c, cfg["num_classes"]), c)], gen,
                           device)
    params = {key: t for (key, _, _), t in zip(convs, ws)}
    params["fc"] = {"w": ws[-1]}
    return params


def program(cfg: dict):
    """The port's VGG-16 forward on the default path (``impl="auto"``,
    fused), after checking that it runs this configuration's structure."""
    from repro_torch.models import cnn

    # the port walks VGG_SPEC's groups and takes every width from the weights
    fixed = {"groups": [g["convs"] for g in cfg["groups"]]
             == [n for _, n in cnn.VGG_SPEC],
             "conv": (cfg["conv_kernel"], cfg["conv_pad"]) == (3, 1),
             "pool": (cfg["pool_window"], cfg["pool_stride"]) == (2, 2),
             "no conv bias": cfg["conv_bias"] is False}
    if not all(fixed.values()):
        raise ValueError("repro_torch's vgg16_apply cannot run this "
                         f"configuration: {fixed}")

    def forward(params, x):
        return cnn.vgg16_apply(params, x, impl="auto", fused=True)
    return forward
