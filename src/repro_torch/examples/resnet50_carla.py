"""ResNet-50 inference through the CARLA conv engine, plus the per-layer
mode/cost table of the full-size network (the paper's Figs 8-10 data).

    PYTHONPATH=src python -m repro_torch.examples.resnet50_carla
        [--device cpu] [--width 0.0625]

The port's ``examples/resnet50_carla.py``: a reduced-width forward (every
CARLA dataflow runs: the CUDA kernels on the card, their plain versions on
the CPU), then the analytic plan of the full-size network.
"""
from __future__ import annotations

import argparse

import torch

from ..core.networks import resnet50_conv_layers
from ..models.cnn import network_plan, resnet50_apply, resnet50_init
from ..models.convert import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--width", type=float, default=0.0625,
                    help="channel width of the functional pass (1 = full)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # reduced-width functional pass (all four CARLA dataflows get exercised)
    gen = torch.Generator().manual_seed(0)
    params = resnet50_init(gen, width=args.width, num_classes=10, device=dev)
    x = torch.randn((1, 64, 64, 3), generator=gen).to(dev)
    logits = resnet50_apply(params, x)
    print("reduced ResNet-50 logits:", tuple(logits.shape), "finite:",
          bool(torch.isfinite(logits).all()))

    # full-size analytic table (the paper's evaluation)
    plans = network_plan(resnet50_conv_layers())
    total_ms = sum(p.cost.cycles for p in plans) / 200e6 * 1e3
    print(f"\n{'layer':18s} {'mode':26s} {'PUF':>6s} {'ms':>7s}")
    for p in plans[:8]:
        print(f"{p.layer.name:18s} {p.dataflow.value:26s} "
              f"{p.cost.puf * 100:5.1f}% {p.cost.time_s * 1e3:7.3f}")
    print(f"... ({len(plans) - 8} more layers)")
    print(f"TOTAL: {total_ms:.1f} ms (paper: 92.7 ms)")


if __name__ == "__main__":
    main()
