"""The whole forward's share of its roofline in the single-stream cells: the
least time the card could take for one forward's work (each conv, pool,
the mean and the fc bound by its operations or its bytes, counted from the
cell's shapes) over the device's busy time per profiled forward.  It reads
the work, not the kernels' names, so a kernel replaced, fused or captured
in a graph changes only the time."""
LAYER = "kernels: kernels/conv2d.py, kernels/matmul.py, csrc/gemm_pipe.cuh, pools and head"
MOVES = "image_ms_p90"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
SCENARIOS = ("single_stream",)


def read(r):
    return r.roofline_percent()
