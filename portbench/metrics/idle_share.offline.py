"""The share of the profiled forwards' wall in which no device operation
runs, in the offline cells: one minus the union of the device's intervals
over the wall."""
LAYER = "device: H100"
MOVES = "images_per_s"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
SCENARIOS = ("offline",)


def read(r):
    return r.idle_percent()
