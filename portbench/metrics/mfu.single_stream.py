"""Model FLOPs utilisation of the window in the single-stream cells: 2 x the
multiply-adds of every conv and the fc at the cell's shapes (the
benchmark's own layer table), times the images completed, over the
window's seconds, as a share of the card's fp32 peak outside the tensor
cores (peaks.json)."""
LAYER = "model: models/cnn.py"
MOVES = "image_ms_p90"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
SCENARIOS = ("single_stream",)


def read(r):
    return r.mfu_percent()
