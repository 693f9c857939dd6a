"""Host milliseconds a forward spends planning its convs: the ``carla.plan``
spans (the controller's choice, the ASIC cost model and the tuning lookup
in ``core/carla.py``), summed over one forward, the median over a pass of
the traffic's profiled forwards with the program's spans on and no
profiler (``portbench/hostspans.py``)."""
from portbench import hostspans

LAYER = "dispatch: core/carla.py, kernels/ops.py, the conv2d and matmul wrappers"
MOVES = "image_ms_p90"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
SCENARIOS = ("single_stream",)


def read(r):
    return hostspans.host_metric(r, ("carla.plan",))
