"""Plain ResNet v1 forward (He et al. 2015, arXiv:1512.03385, Table 1) in
fp32, with inference-folded batch norm.

Per bottleneck: 1x1 (carrying the block's stride, v1) -> BN -> ReLU, 3x3
-> BN -> ReLU, 1x1 -> BN, plus the shortcut (a strided 1x1 and BN on a
group's first block, else the identity), then ReLU.  The stem is a 7x7
stride-2 conv, BN, ReLU and a 3x3 stride-2 max-pool padded as XLA's SAME;
the head a global mean and the fc.  Folded BN is y * scale + bias after
the conv.  Weights as the harness drew them: HWIO, 1x1 as (C, K).
"""
from __future__ import annotations

import torch

from .common import conv, matmul, max_pool, precision


def _bn(y: torch.Tensor, p: dict) -> torch.Tensor:
    return y * p["scale"].float()[:, None, None] + p["bias"].float()[:, None,
                                                                      None]


def forward(cfg: dict, params: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) images -> (B, classes) logits in fp32 (TF32 off, or
    on for the control)."""
    p = params
    with precision(x.device, tf32):
        h = x.float().permute(0, 3, 1, 2)
        h = torch.relu(_bn(conv(h, p["conv1"].float(), cfg["stem_stride"],
                                cfg["stem_pad"], tf32), p["bn1"]))
        h = max_pool(h, cfg["pool_window"], cfg["pool_stride"], same=True)
        for g in cfg["groups"]:
            for b in range(g["blocks"]):
                blk = p[f"{g['name']}_b{b}"]
                s = g["stride"] if b == 0 else 1
                if b == 0:
                    sc = _bn(conv(h, blk["proj"].float(), s, 0, tf32),
                             blk["bnp"])
                else:
                    sc = h
                y = torch.relu(_bn(conv(h, blk["c1"].float(), s, 0, tf32),
                                   blk["bn1"]))
                y = torch.relu(_bn(conv(y, blk["c2"].float(), 1, 1, tf32),
                                   blk["bn2"]))
                h = torch.relu(_bn(conv(y, blk["c3"].float(), 1, 0, tf32),
                                   blk["bn3"]) + sc)
        return matmul(h.mean(dim=(2, 3)), p["fc"]["w"].float(), tf32)
