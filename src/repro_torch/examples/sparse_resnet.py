"""Structured sparsity (paper §IV.A): prune 50% of channels by L1 importance
and show the CARLA latency/DRAM win — 42.5 ms / 63.3 MB in the paper — then
run the pruned network end-to-end through the real kernels.

    PYTHONPATH=src python -m repro_torch.examples.sparse_resnet
        [--device cpu] [--width 0.0625]

The port's ``examples/sparse_resnet.py``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.cost_model import layer_cost, resnet50_cost
from ..core.networks import resnet50_conv_layers
from ..core.sparsity import prune_conv_weights, prune_plan, topk_channel_mask
from ..models import cnn
from ..models.convert import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--width", type=float, default=0.0625,
                    help="channel width of the measured pass (1 = full)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # functional pruning of an actual conv weight
    w = torch.randn((3, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    keep = topk_channel_mask(w, keep_fraction=0.5)
    wp = prune_conv_weights(w, keep)
    print(f"pruned weights: {tuple(w.shape)} -> {tuple(wp.shape)} (keeps "
          "highest-L1 channels)")

    # channel propagation through a chain (the paper's Table I pattern):
    # each layer's input channels are the previous layer's pruned output
    # channels, starting from the chain's real input count (3 for RGB)
    chain = prune_plan([64, 64, 256], [0.5, 0.5, 1.0], ic0=3)
    print("pruned chain (IC, K):", chain)

    # whole-network effect, dense vs sparse
    d, s = resnet50_cost(), resnet50_cost(sparse=True)
    print(f"dense : {d.time_ms:6.1f} ms  {d.dram_mb:6.1f} MB")
    print(f"sparse: {s.time_ms:6.1f} ms  {s.dram_mb:6.1f} MB "
          f"({d.cycles / s.cycles:.2f}x faster, paper: 92.7 -> 42.5 ms)")

    # per-layer speedup buckets (paper: 2x where IC halves, 4x where both)
    for name in ("conv2_b1_3x3", "conv4_b1_3x3", "conv4_b1_1x1b"):
        dl = next(l for l in resnet50_conv_layers() if l.name == name)
        sl = next(l for l in resnet50_conv_layers(sparse=True)
                  if l.name == name)
        r = layer_cost(dl).cycles / layer_cost(sl).cycles
        print(f"{name:16s} speedup {r:.1f}x")

    # the measured path: prune a real weight tree (residual-aware: masks
    # propagate 1x1a -> 3x3 -> 1x1b inside each bottleneck, the shortcut
    # trunk stays dense) and run the pruned network through carla_conv with
    # fused epilogues; --width 1 for the real net
    params = cnn.resnet50_init(torch.Generator().manual_seed(1),
                               width=args.width, device=dev)
    pruned, masks = cnn.resnet50_prune(params, keep_fractions=0.5)
    m1, m2 = masks["conv3_b1"]
    print(f"conv3_b1: kept {int(m1.sum())}/{len(m1)} 1x1a channels, "
          f"{int(m2.sum())}/{len(m2)} 3x3 channels")

    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 56, 56, 3)).astype(np.float32)).to(dev)
    dense_out = cnn.resnet50_apply(params, x)
    sparse_out = cnn.resnet50_apply(params, x, sparse=True)  # prunes + tags
    prepruned_out = cnn.resnet50_apply(pruned, x)            # already pruned
    print(f"forward: dense logits {tuple(dense_out.shape)}, sparse logits "
          f"{tuple(sparse_out.shape)} (prepruned matches: "
          f"{bool(torch.allclose(sparse_out, prepruned_out))})")


if __name__ == "__main__":
    main()
