"""Quickstart: CARLA's reconfigurable convolution + its analytic cost model.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's ``examples/quickstart.py``: one 3x3 conv through the mode
dispatcher (the CUDA kernel on the card, its plain version on the CPU),
the controller's plan and the paper's analytic cost for that layer, the
whole-network headline numbers, and the two 1x1 operand-swap modes.
"""
from __future__ import annotations

import argparse

import torch

from ..core.carla import carla_conv, plan_conv
from ..core.cost_model import resnet50_cost
from ..models.convert import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. A convolution through the CARLA mode dispatcher
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 56, 56, 64), generator=gen).to(dev)      # NHWC
    w = (torch.randn((3, 3, 64, 64), generator=gen) * 0.05).to(dev)  # HWIO
    y = carla_conv(x, w, padding=1)               # 3x3 serial-accum mode
    print("3x3 conv out:", tuple(y.shape))

    # 2. The controller's plan + the paper's analytic cost for this layer
    plan = plan_conv(tuple(x.shape), tuple(w.shape), stride=1, padding=1)
    c = plan.cost
    print(f"mode={plan.dataflow.value}  cycles={c.cycles:,}  "
          f"PUF={c.puf * 100:.1f}%  DRAM={c.dram_bytes / 1e6:.2f} MB")

    # 3. Whole-network reproduction of the paper's headline numbers
    r50 = resnet50_cost()
    print(f"ResNet-50 on CARLA: {r50.time_ms:.1f} ms (paper: 92.7), "
          f"{r50.dram_mb:.1f} MB DRAM (paper: 124.0), {r50.gops:.1f} Gops")

    # 4. The 1x1 operand-swap modes (feature- vs weight-stationary)
    for il in (56, 7):   # large fmap -> feature-stationary; 7x7 -> weight
        p = plan_conv((1, il, il, 256), (1, 1, 256, 512))
        print(f"1x1 @ {il}x{il}: {p.dataflow.value}  "
              f"PUF={p.cost.puf * 100:.1f}%")


if __name__ == "__main__":
    main()
