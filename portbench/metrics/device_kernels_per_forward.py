"""Device operations (kernels, copies, sets) per forward, the logits' copy
to the host included, counted in the profiled forwards."""
LAYER = "dispatch: core/carla.py, kernels/ops.py, the conv2d and matmul wrappers"
MOVES = "image_ms_p90"
UNIT = "ops"
BETTER = "lower"
SOURCE = "device_trace"
SCENARIOS = ("single_stream",)


def read(r):
    if r.profile is None or not r.profile.device_ops:
        return None
    return r.profile.device_ops / r.profile.forwards
