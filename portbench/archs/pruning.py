"""What the benchmark reads of the port's pruned forward: whether its
ResNet-50 entry keeps a pruned set and records a ``cnn.prune`` span around
its lookup.  ``metrics/host_prune_ms.py`` reads the program through this,
as ``hostspans.py`` reads its tracing through ``archs/tracing.py``."""
from __future__ import annotations


def has_prune_span() -> bool:
    """Whether ``resnet50_apply`` looks its pruned set up under a
    ``cnn.prune`` span (a program that counts ``prune_hits``), where a
    program without it prunes on every call and records no such span."""
    from repro_torch.models import cnn
    return hasattr(cnn.resnet50_apply, "prune_hits")
