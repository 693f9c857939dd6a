"""Host milliseconds a forward spends issuing the PyTorch ops the model
runs itself: the ``cnn.pool`` and ``cnn.head`` spans of
``models/cnn.py`` (max-pools; the mean, the fc weight's cast and the
product), summed over one forward, the median over the spans-only pass
(``portbench/hostspans.py``)."""
from portbench import hostspans

LAYER = "model: models/cnn.py"
MOVES = "image_ms_p90"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
SCENARIOS = ("single_stream",)


def read(r):
    return hostspans.host_metric(r, hostspans.POOL_HEAD)
