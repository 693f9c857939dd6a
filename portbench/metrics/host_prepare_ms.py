"""Host milliseconds a forward spends in the kernel wrappers' preparation:
the self time of the ``kernels.conv2d``, ``kernels.conv1x1`` and
``kernels.gemm`` spans (their duration less their ``kernels.launch``
child: resolving the engine, operand checks, the device's properties, the
tile plan, workspace, output allocation and the device context), summed
over one forward, the median over the spans-only pass
(``portbench/hostspans.py``)."""
from portbench import hostspans

LAYER = "dispatch: core/carla.py, kernels/ops.py, the conv2d and matmul wrappers"
MOVES = "image_ms_p90"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
SCENARIOS = ("single_stream",)


def read(r):
    return hostspans.host_metric(r, hostspans.PREPARE, self_time=True)
