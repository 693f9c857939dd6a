"""Host milliseconds a forward spends finding its pruned weights: the
``cnn.prune`` span of ``models/cnn.py`` (the lookup of the net's pruned
set, and the pruning on a miss), summed over one forward, the median over
the spans-only pass (``portbench/hostspans.py``).  0.0 in a forward of
dense weights, which looks nothing up; None for a program that records no
such span (``archs/pruning.py``)."""
import statistics

from portbench import hostspans
from portbench.archs import pruning

LAYER = "model: models/cnn.py"
MOVES = "image_ms_p90"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
SCENARIOS = ("single_stream",)


def read(r):
    if not pruning.has_prune_span():
        return None
    p = hostspans.passes(r)
    if p is None:
        return None
    per = hostspans.per_forward_ms(p.host, ("cnn.prune",))
    return statistics.median(per) if per else 0.0
