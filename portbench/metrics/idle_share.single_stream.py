"""The share of the profiled forwards' wall in which no device operation
runs, in the single-stream cells: one minus the union of the device's intervals
over the wall."""
LAYER = "device: H100"
MOVES = "image_ms_p90"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
SCENARIOS = ("single_stream",)


def read(r):
    return r.idle_percent()
