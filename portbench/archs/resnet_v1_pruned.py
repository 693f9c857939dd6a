"""ResNet v1 channel-pruned as CARLA's Sec. IV.A and Table I prune it
(arXiv:2010.00627): in every bottleneck the first 1x1 and the 3x3 keep
``keep_fraction`` of their output channels, chosen by L1 importance, and
the masks carry into the next conv's inputs (1x1a -> 3x3 -> 1x1b); the
stem, the projections, each block's closing 1x1 outputs and the fc stay
dense.

``draw`` gives the dense weights, exactly as ``resnet_v1.draw``: the
program is handed them on every call, as a user of the port's sparse entry
hands them, and owns the pruning.  ``layers`` is the work the pruned
forward has to do, so ``mfu`` and ``forward_roofline`` count pruned
operations and bytes.
"""
from __future__ import annotations

from . import resnet_v1, work

draw = resnet_v1.draw


def kept(channels: int, keep: float) -> int:
    """The channels a mask keeps of ``channels``."""
    return max(1, round(channels * keep))


def pruned_config(cfg: dict) -> dict:
    """``cfg`` with every group's ``mid`` at the width the pruned forward
    runs."""
    groups = [{**g, "mid": kept(g["mid"], cfg["keep_fraction"])}
              for g in cfg["groups"]]
    return {**cfg, "groups": groups}


def layers(cfg: dict, batch: int) -> list[work.Op]:
    return resnet_v1.layers(pruned_config(cfg), batch)


def program(cfg: dict):
    """The port's ResNet-50 forward on the default path (``impl="auto"``,
    fused) with the configuration's keep fraction, on the dense weights,
    after ``resnet_v1.program``'s checks of the structure."""
    from repro_torch.models import cnn

    resnet_v1.program(cfg)
    keep = cfg["keep_fraction"]
    if not 0.0 < keep < 1.0:
        raise ValueError(f"keep_fraction {keep!r} is not in (0, 1)")

    def forward(params, x):
        return cnn.resnet50_apply(params, x, impl="auto", fused=True,
                                  keep_fractions=keep)
    return forward
