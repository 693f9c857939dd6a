"""The squeeze-and-excitation gates' share of their roofline in the
single-stream cells: the least time the card could take for each block's
gate and the pass that applies it (the benchmark's own ops
``<block>_se.mean``, ``.fc1``, ``.fc2`` and ``.scale``, by the ``layer``
of the block's ``cnn.se`` span) over the device time of the kernels
matched to them in a profiled pass with the program's spans on
(``portbench/routeshare.py``: a kernel is matched by the runtime record of
its launch, a ``kernels.launch`` span of route ``se`` or ``se_scale``,
never by its name).  0.0 in a cell whose net has no SE gate; None for a program
without the route."""
from portbench import routeshare

LAYER = "kernels: kernels/conv2d.py, kernels/matmul.py, csrc/gemm_pipe.cuh, pools and head"
MOVES = "image_ms_p90"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
SCENARIOS = ("single_stream",)


def read(r):
    return routeshare.roofline(r, ("se", "se_scale"), "cnn.se")
