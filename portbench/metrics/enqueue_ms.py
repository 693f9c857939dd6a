"""Host milliseconds from a forward's call to its return, before anything
waits for the device: the dispatch layer's cost per image.  The median over
the traced run's window, which the profiler does not touch."""
import statistics

LAYER = "dispatch: core/carla.py, kernels/ops.py, the conv2d and matmul wrappers"
MOVES = "image_ms_p90"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
SCENARIOS = ("single_stream",)


def read(r):
    return statistics.median(r.window.enqueue_ms) if r.window.enqueue_ms \
        else None
