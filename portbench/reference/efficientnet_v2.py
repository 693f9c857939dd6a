"""Plain EfficientNetV2 forward (Tan and Le, ICML 2021, arXiv:2104.00298,
Table 4; the block strings of ``v2_s_block`` in google/automl's
``efficientnetv2/effnetv2_configs.py``) in fp32, with inference-folded
batch norm.

Per stage of the configuration, ``repeats`` blocks, the stride on the
first:

* MBConv: 1x1 to ``expand * C_in`` -> BN -> SiLU; a depthwise k x k conv
  (``groups`` = channels) at the stride -> BN -> SiLU; the
  squeeze-and-excitation gate ``sigmoid(fc2(SiLU(fc1(mean_hw(d)))))``,
  fc1 reducing to ``int(se_ratio * C_in)``, both fcs with a bias; the map
  times the gate; 1x1 to ``C_out`` -> BN; plus the block's input where the
  stride is 1 and ``C_in == C_out``.
* Fused-MBConv, expand > 1: k x k conv to ``expand * C_in`` at the stride
  -> BN -> SiLU; 1x1 to ``C_out`` -> BN; plus the input where the block
  keeps its shape.  Expand 1: k x k conv to ``C_out`` -> BN -> SiLU, plus
  the input.

The stem is a 3x3 stride-2 conv -> BN -> SiLU; the head a 1x1 -> BN ->
SiLU, a global mean and the fc with its bias.  Folded BN is y * scale +
bias after the conv.  Weights as the harness drew them: HWIO, a 1x1 as
(C, K), a depthwise filter as (k, k, 1, C).

Departures from the TF reference, each as the configuration's
``assumed`` states: padding is symmetric, (k - 1) // 2 (as torchvision's
``efficientnet_v2_s``), where TF pads SAME, asymmetrically at stride 2
(the same shapes and work, other windows); batch norm is folded and drawn
from the seed; dropout and stochastic depth are off (inference); the
weights are random.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import conv, matmul, precision


def _bn(y: torch.Tensor, p: dict) -> torch.Tensor:
    return y * p["scale"].float()[:, None, None] + p["bias"].float()[:, None,
                                                                      None]


def _dw(h: torch.Tensor, w: torch.Tensor, stride: int,
        tf32: bool) -> torch.Tensor:
    """Depthwise: h NCHW, w (k, k, 1, C).  Each output is k*k products of
    one channel, which TF32's matmul switch does not reach (cuDNN is off,
    and PyTorch's own depthwise conv sums in fp32 whatever the switch), so
    the control is the same here as the reference."""
    k = w.shape[0]
    return F.conv2d(h, w.float().permute(3, 2, 0, 1), stride=stride,
                    padding=(k - 1) // 2, groups=h.shape[1])


def _se(d: torch.Tensor, p: dict, tf32: bool) -> torch.Tensor:
    """The gate (B, C) of the map d (NCHW)."""
    h = F.silu(matmul(d.mean(dim=(2, 3)), p["w1"].float(), tf32)
               + p["b1"].float())
    return torch.sigmoid(matmul(h, p["w2"].float(), tf32) + p["b2"].float())


def blocks(cfg: dict):
    """(key, stage, cin, cout, stride) of every block in order."""
    cin = cfg["stem_channels"]
    for si, st in enumerate(cfg["stages"]):
        for b in range(st["repeats"]):
            yield (f"s{si + 1}_b{b}", st, cin if b == 0 else st["out"],
                   st["out"], st["stride"] if b == 0 else 1)
        cin = st["out"]


def forward(cfg: dict, params: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) images -> (B, classes) logits in fp32 (TF32 off, or
    on for the control)."""
    p = params
    k0 = cfg["stem_kernel"]
    with precision(x.device, tf32):
        h = x.float().permute(0, 3, 1, 2)
        h = F.silu(_bn(conv(h, p["stem"]["w"].float(), cfg["stem_stride"],
                            (k0 - 1) // 2, tf32), p["stem"]["bn"]))
        for key, st, cin, cout, s in blocks(cfg):
            blk, k = p[key], st["kernel"]
            keep = s == 1 and cin == cout
            if st["fused"] and st["expand"] == 1:
                y = F.silu(_bn(conv(h, blk["conv"].float(), s, (k - 1) // 2,
                                    tf32), blk["bn"]))
            elif st["fused"]:
                y = F.silu(_bn(conv(h, blk["expand"].float(), s,
                                    (k - 1) // 2, tf32), blk["bn1"]))
                y = _bn(conv(y, blk["project"].float(), 1, 0, tf32),
                        blk["bn2"])
            else:
                y = F.silu(_bn(conv(h, blk["expand"].float(), 1, 0, tf32),
                               blk["bn1"]))
                y = F.silu(_bn(_dw(y, blk["dw"], s, tf32), blk["bn2"]))
                y = y * _se(y, blk["se"], tf32)[:, :, None, None]
                y = _bn(conv(y, blk["project"].float(), 1, 0, tf32),
                        blk["bn3"])
            h = y + h if keep else y
        h = F.silu(_bn(conv(h, p["head"]["w"].float(), 1, 0, tf32),
                       p["head"]["bn"]))
        logits = matmul(h.mean(dim=(2, 3)), p["fc"]["w"].float(), tf32)
        if cfg["fc_bias"]:
            logits = logits + p["fc"]["b"].float()
        return logits
