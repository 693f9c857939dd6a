"""The depthwise conv's share of its roofline in the single-stream cells:
the least time the card could take for the dispatches that ran the
depthwise kernel (each layer's operations or bytes from the benchmark's
own table, by the ``layer`` of its ``carla_conv`` span) over the device
time of the kernels matched to those dispatches in a profiled pass with
the program's spans on (``portbench/routeshare.py``: a kernel is matched by
the runtime record of its launch, a ``kernels.launch`` span of route
``dwconv``, never by its name).  0.0 in a cell whose net has no
depthwise conv; None for a program without the route."""
from portbench import routeshare

LAYER = "kernels: kernels/conv2d.py, kernels/matmul.py, csrc/gemm_pipe.cuh, pools and head"
MOVES = "image_ms_p90"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
SCENARIOS = ("single_stream",)


def read(r):
    return routeshare.roofline(r, ("dwconv",), "carla_conv")
