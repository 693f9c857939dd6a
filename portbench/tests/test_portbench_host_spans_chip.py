"""On the GPU, at each single-stream cell's own size: a traced forward has
one ``kernels.launch`` span a conv (53 ResNet-50, 13 VGG-16), every
``carla::pipe_conv_kernel`` of a profiled pass is matched to exactly one
dispatch, and none starts before its launch span on the shared clock.
Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -q \
        portbench/tests/test_portbench_host_spans_chip.py
"""
import pytest

from portbench import hostspans, spec
from portbench.archs import tracing

FORWARDS = 3


@pytest.mark.chip
@pytest.mark.parametrize("cell,convs", [("resnet50.single_stream", 53),
                                        ("vgg16.single_stream", 13)])
def test_every_conv_kernel_is_matched_to_its_launch(cuda, cell, convs):
    runner = hostspans._runner(spec.cell(cell), hostspans.SEED)
    cap, ops, _, clock_ok = hostspans._profiled(runner, FORWARDS,
                                                tracing.recorder())
    assert clock_ok, "the profiler's device clock slipped in every try"
    assert [root.name for root in cap.spans] == ["cnn.forward"] * FORWARDS
    for root in cap.spans:
        assert sum(s.name == "kernels.launch" for s in root.walk()) == convs
    matched = hostspans.matches(cap.spans, cap.anchor, ops)
    # the test, not the matching, tells the port's kernels by their name
    kernels = [op for op in ops if "carla::pipe_conv_kernel" in op.name]
    assert len(kernels) == FORWARDS * convs
    assert sorted(map(id, kernels)) == sorted(id(op) for op, _, _ in matched)
    launches = {id(launch) for _, launch, _ in matched}
    assert len(launches) == len(matched)
    for op, launch, _ in matched:
        assert op.start_ns >= hostspans._ns(launch, cap.anchor)[0]
