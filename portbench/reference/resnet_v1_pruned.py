"""Plain fp32 forward of ResNet v1 channel-pruned as CARLA prunes it
(arXiv:2010.00627, Sec. IV.A and Table I), from the dense weights the
harness drew.

Each bottleneck's masks, by this rule:

  * importance of output channel k: the sum of |w| over every axis but the
    last, in float32 on the host, by numpy's sum over the weight as drawn
    (HWIO, or (C, K) for a 1x1);
  * n_keep = max(1, round(K x keep)), Python's round;
  * the n_keep channels of highest importance are kept; of equal
    importances the lower index goes first;
  * m1 from the dense 1x1a, m2 from the dense 3x3 over all of its input
    channels.

The 1x1a keeps its outputs m1, the 3x3 its inputs m1 and outputs m2, the
1x1b its inputs m2, each conv with its folded BN's entries; every other
weight stays dense.  Then ``resnet_v1.forward`` runs the sliced weights.

numpy is reached through ``Tensor.numpy``: its float32 sum is the one
rounding of the importances, so equal weights give equal masks.
"""
from __future__ import annotations

import torch

from . import resnet_v1


def importance(w: torch.Tensor) -> list:
    """The float32 L1 importance of each output channel of ``w``."""
    a = w.detach().float().cpu().numpy()
    return abs(a).sum(axis=tuple(range(a.ndim - 1))).tolist()


def mask(w: torch.Tensor, keep: float) -> list[int]:
    """The kept output channels of ``w``, in increasing order."""
    imp = importance(w)
    n = max(1, round(len(imp) * keep))
    order = sorted(range(len(imp)), key=lambda k: (-imp[k], k))
    return sorted(order[:n])


def masks(cfg: dict, params: dict) -> dict:
    """(m1, m2) of every bottleneck, by its key."""
    keep = cfg["keep_fraction"]
    return {key: (mask(params[key]["c1"], keep),
                  mask(params[key]["c2"], keep))
            for key in _blocks(cfg)}


def _blocks(cfg: dict):
    return [f"{g['name']}_b{b}" for g in cfg["groups"]
            for b in range(g["blocks"])]


def _take(t: torch.Tensor, dim: int, idx: list[int]) -> torch.Tensor:
    return t.index_select(dim, torch.tensor(idx, device=t.device))


def _bn(bn: dict, idx: list[int]) -> dict:
    return {k: _take(v, 0, idx) for k, v in bn.items()}


def prune(cfg: dict, params: dict) -> dict:
    """The weights the pruned network runs."""
    out = dict(params)
    for key, (m1, m2) in masks(cfg, params).items():
        blk = params[key]
        out[key] = {**blk,
                    "c1": _take(blk["c1"], 1, m1), "bn1": _bn(blk["bn1"], m1),
                    "c2": _take(_take(blk["c2"], 2, m1), 3, m2),
                    "bn2": _bn(blk["bn2"], m2),
                    "c3": _take(blk["c3"], 0, m2)}
    return out


def forward(cfg: dict, params: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) images -> (B, classes) logits in fp32 (TF32 off, or
    on for the control), params dense as drawn."""
    return resnet_v1.forward(cfg, prune(cfg, params), x, tf32)
