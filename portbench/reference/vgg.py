"""Plain VGG forward (Simonyan and Zisserman 2014, arXiv:1409.1556,
configuration D for VGG-16) in fp32.

Per group: its 3x3 convs, each followed by ReLU, then a 2x2 stride-2
max-pool.  The head is the one the port runs: a global mean and one fc, in
place of the paper's three fully connected layers.  Weights as the harness
drew them: HWIO.
"""
from __future__ import annotations

import torch

from .common import conv, matmul, max_pool, precision


def forward(cfg: dict, params: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) images -> (B, classes) logits in fp32 (TF32 off, or
    on for the control)."""
    with precision(x.device, tf32):
        h = x.float().permute(0, 3, 1, 2)
        for gi, g in enumerate(cfg["groups"]):
            for li in range(g["convs"]):
                h = torch.relu(conv(h, params[f"g{gi}_c{li}"].float(), 1,
                                    cfg["conv_pad"], tf32))
            h = max_pool(h, cfg["pool_window"], cfg["pool_stride"],
                         same=False)
        return matmul(h.mean(dim=(2, 3)), params["fc"]["w"].float(), tf32)
