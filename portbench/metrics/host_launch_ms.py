"""Host milliseconds a forward spends launching its kernels: the
``kernels.launch`` spans (the ctypes call into the built library, which
sets the kernel's attributes and launches it, and the check of its
error), summed over one forward, the median over the spans-only pass
(``portbench/hostspans.py``)."""
from portbench import hostspans

LAYER = "dispatch: core/carla.py, kernels/ops.py, the conv2d and matmul wrappers"
MOVES = "image_ms_p90"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
SCENARIOS = ("single_stream",)


def read(r):
    return hostspans.host_metric(r, ("kernels.launch",))
