"""The conv2d route's share of its roofline in the offline cells: the least
time the card could take for the dispatches that ran the implicit-GEMM
conv kernel (the 3x3 and 7x7 convs; each layer's operations or bytes
from the benchmark's own table, by name) over the device time of the
kernels matched to those dispatches in a profiled pass with the program's
spans on (``portbench/hostspans.py``: a kernel is matched by the
runtime record of its launch, never by its name)."""
from portbench import hostspans

LAYER = "kernels: kernels/conv2d.py, kernels/matmul.py, csrc/gemm_pipe.cuh, pools and head"
MOVES = "images_per_s"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
SCENARIOS = ("offline",)


def read(r):
    return hostspans.roofline_metric(r, "conv2d")
