"""EfficientNetV2 (Tan and Le, ICML 2021, arXiv:2104.00298) as the port's
``models/efficientnet.py`` runs it: Fused-MBConv and MBConv blocks with
folded BN, SiLU, each MBConv's depthwise conv, squeeze-and-excitation gate
gate pass and projection, the head's 1x1, mean and an fc with a bias.

``layers`` is the benchmark's own table of the forward's work, named as the
program's spans name the layers: ``carla_conv``'s ``layer`` for each conv
(``stem``, ``<block>_conv``, ``<block>_expand``, ``<block>_dw``,
``<block>_project``, ``head``), and for a block's gate, under its
``cnn.se`` span's ``layer`` (``<block>_se``), four ops: ``<block>_se.mean``,
``<block>_se.fc1``, ``<block>_se.fc2`` and ``<block>_se.scale`` (the pass
that applies the gate to the map).  ``draw`` gives the weights in
the port's layout (NHWC activations, HWIO weights, a 1x1 as (C, K), a
depthwise filter as (k, k, 1, C)), ``program`` the port's entry on them.
"""
from __future__ import annotations

import dataclasses

import torch

from . import work


def blocks(cfg: dict):
    """(key, stage, cin, expanded, cout, stride, SE width) of every block
    in order."""
    cin = cfg["stem_channels"]
    for si, st in enumerate(cfg["stages"]):
        for b in range(st["repeats"]):
            c = cin if b == 0 else st["out"]
            se = int(st["se_ratio"] * c) if st["se_ratio"] else 0
            yield (f"s{si + 1}_b{b}", st, c, c * st["expand"], st["out"],
                   st["stride"] if b == 0 else 1, se)
        cin = st["out"]


# output pixels a tile whose channel sums the depthwise conv writes for its
# block's SE mean (the port's csrc/dwconv.cu: DW_TILE_PIX)
TILE_PIX = 16


def sum_tiles(oh: int, ow: int) -> int:
    return -(-oh * ow // TILE_PIX)


def dwconv(name: str, n: int, h: int, w: int, c: int, k: int, stride: int,
           item: int, *, sums: bool = False) -> tuple[work.Op, int, int]:
    """A depthwise k x k conv, padding (k - 1) // 2, with folded BN and
    SiLU in its flush; returns (op, oh, ow).  ``macs`` counts k*k a channel
    and output pixel, pads included; ``flops`` only the taps inside the
    input; the bytes read the input and write the output once.  With
    ``sums`` it also reduces its outputs to fp32 channel sums a tile of
    TILE_PIX pixels (one add an output, the sums written once): the part of
    its block's SE mean that reads the map."""
    pad = (k - 1) // 2
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    macs = n * oh * ow * c * k * k
    inside = (n * c * work.taps(h, oh, k, stride, pad)
              * work.taps(w, ow, k, stride, pad))
    nbytes = (item * (n * h * w * c + k * k * c + n * oh * ow * c)
              + work.EPILOGUE_BYTES * 2 * c)
    flops = 2 * inside
    if sums:
        flops += n * oh * ow * c
        nbytes += 4 * n * sum_tiles(oh, ow) * c
    return work.Op(name, "dwconv", flops, 2 * macs, nbytes, macs), oh, ow


def fc(name: str, n: int, c: int, k: int, item: int) -> work.Op:
    """An fc with a bias (fp32, added once an output)."""
    op = work.fc(name, n, c, k, item)
    return dataclasses.replace(op, flops=op.flops + n * k,
                               bytes=op.bytes + work.EPILOGUE_BYTES * k)


def se_ops(name: str, n: int, oh: int, ow: int, c: int, r: int,
           item: int) -> list[work.Op]:
    """A squeeze-and-excitation gate of an (oh, ow, c) map whose depthwise
    conv left its channel sums a tile (``dwconv``'s ``sums``): the mean
    from those sums (each read and added once), then fc1 (c -> r) and fc2
    (r -> c), each with its bias; then the pass that scales the map by it
    (the map read and written once, the fp32 gate read)."""
    tiles = n * sum_tiles(oh, ow) * c
    pixels = n * oh * ow * c
    return [work.Op(f"{name}.mean", "mean", tiles, 0, 4 * tiles),
            fc(f"{name}.fc1", n, c, r, item),
            fc(f"{name}.fc2", n, r, c, item),
            work.Op(f"{name}.scale", "scale", pixels, 0,
                    2 * item * pixels + 4 * n * c)]


def layers(cfg: dict, batch: int) -> list[work.Op]:
    item = work.ITEM_BYTES[cfg["dtype"]]
    n, s = batch, cfg["image_size"]
    k0 = cfg["stem_kernel"]
    stem, h, w = work.conv("stem", n, s, s, cfg["in_channels"],
                           cfg["stem_channels"], k0, cfg["stem_stride"],
                           (k0 - 1) // 2, bn=True, residual=False, item=item)
    ops = [stem]
    for key, st, cin, cexp, cout, stride, se in blocks(cfg):
        k, pad = st["kernel"], (st["kernel"] - 1) // 2
        keep = stride == 1 and cin == cout
        if st["fused"] and st["expand"] == 1:
            op, h, w = work.conv(f"{key}_conv", n, h, w, cin, cout, k,
                                 stride, pad, bn=True, residual=keep,
                                 item=item)
            ops.append(op)
        elif st["fused"]:
            a, h, w = work.conv(f"{key}_expand", n, h, w, cin, cexp, k,
                                stride, pad, bn=True, residual=False,
                                item=item)
            b, _, _ = work.conv(f"{key}_project", n, h, w, cexp, cout, 1, 1,
                                0, bn=True, residual=keep, item=item)
            ops += [a, b]
        else:
            a, _, _ = work.conv(f"{key}_expand", n, h, w, cin, cexp, 1, 1, 0,
                                bn=True, residual=False, item=item)
            d, h, w = dwconv(f"{key}_dw", n, h, w, cexp, k, stride, item,
                             sums=True)
            p, _, _ = work.conv(f"{key}_project", n, h, w, cexp, cout, 1, 1,
                                0, bn=True, residual=keep, item=item)
            ops += [a, d, *se_ops(f"{key}_se", n, h, w, cexp, se, item), p]
    c = cfg["stages"][-1]["out"]
    head, _, _ = work.conv("head", n, h, w, c, cfg["head_channels"], 1, 1, 0,
                           bn=True, residual=False, item=item)
    last = cfg["head_channels"]
    return ops + [head, work.mean("mean", n, h, w, last, item),
                  fc("fc", n, last, cfg["num_classes"], item)]


def draw(cfg: dict, gen: torch.Generator, device) -> dict:
    """Weights from ``gen`` on ``device``: convs He-scaled (std
    fan_in^-1/2; a depthwise filter's fan-in is k*k), the SE fcs and the
    fc scaled by their input width; BN scale and bias, the SE biases and
    the fc's bias drawn (scale in [0.5, 1.5), biases in [-0.5, 0.5))."""
    k0 = cfg["stem_kernel"]
    shapes = [((k0, k0, cfg["in_channels"], cfg["stem_channels"]),
               k0 * k0 * cfg["in_channels"])]
    widths = [cfg["stem_channels"]]
    plan = []                      # (key, [weight names], [bn names])
    for key, st, cin, cexp, cout, _, se in blocks(cfg):
        k = st["kernel"]
        if st["fused"] and st["expand"] == 1:
            shapes.append(((k, k, cin, cout), k * k * cin))
            widths.append(cout)
            plan.append((key, ["conv"], ["bn"]))
        elif st["fused"]:
            shapes += [((k, k, cin, cexp), k * k * cin), ((cexp, cout), cexp)]
            widths += [cexp, cout]
            plan.append((key, ["expand", "project"], ["bn1", "bn2"]))
        else:
            shapes += [((cin, cexp), cin), ((k, k, 1, cexp), k * k),
                       ((cexp, se), cexp), ((se, cexp), se),
                       ((cexp, cout), cexp)]
            # the SE biases: the bias halves of two more BN draws
            widths += [cexp, cexp, se, cexp, cout]
            plan.append((key, ["expand", "dw", "w1", "w2", "project"],
                         ["bn1", "bn2", "b1", "b2", "bn3"]))
    c, last = cfg["stages"][-1]["out"], cfg["head_channels"]
    shapes += [((c, last), c), ((last, cfg["num_classes"]), last)]
    widths += [last, cfg["num_classes"]]
    ws = iter(work.draw_weights(shapes, gen, device))
    bns = iter(work.draw_bn(widths, gen, device))
    params = {"stem": {"w": next(ws), "bn": next(bns)}}
    for key, wnames, bnames in plan:
        blk = {name: next(ws) for name in wnames}
        for name in bnames:
            blk[name] = next(bns)
        if "w1" in blk:
            blk["se"] = {"w1": blk.pop("w1"), "b1": blk.pop("b1")["bias"],
                         "w2": blk.pop("w2"), "b2": blk.pop("b2")["bias"]}
        params[key] = blk
    params["head"] = {"w": next(ws), "bn": next(bns)}
    params["fc"] = {"w": next(ws), "b": next(bns)["bias"]}
    return params


def program(cfg: dict):
    """The port's EfficientNetV2-S forward on the default path
    (``impl="auto"``, fused), after checking that it runs this
    configuration's structure."""
    from repro_torch.models import efficientnet

    want = [("fused" if st["fused"] else "mbconv", st["repeats"],
             st["kernel"], st["stride"], st["expand"], st["out"],
             st["se_ratio"]) for st in cfg["stages"]]
    fixed = {"stages": want == [tuple(t) for t in efficientnet.EFFNETV2_S],
             "stem": (cfg["stem_channels"], cfg["stem_kernel"],
                      cfg["stem_stride"]) == (efficientnet.STEM, 3, 2),
             "stage inputs": all(
                 st["in"] == (cfg["stem_channels"] if i == 0
                              else cfg["stages"][i - 1]["out"])
                 for i, st in enumerate(cfg["stages"])),
             "head": cfg["head_channels"] == efficientnet.HEAD,
             "fc bias": cfg["fc_bias"] is True}
    if not all(fixed.values()):
        raise ValueError("repro_torch's efficientnetv2_s_apply cannot run "
                         f"this configuration: {fixed}")

    def forward(params, x):
        return efficientnet.efficientnetv2_s_apply(params, x, impl="auto",
                                                   fused=True)
    return forward
