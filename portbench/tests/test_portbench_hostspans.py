"""The readers of the program's spans (``hostspans.py``) on a synthetic
forward whose every number is known: the host metrics, the idle split by
the host's innermost span, the match of device ops to their launches and
the route rooflines; and None wherever a run has nothing to read."""
import pytest

from portbench import devtrace, harness, hostspans, spec
from portbench.archs import tracing, work
from repro_torch.observability import trace

WALL = 1_790_000_000_000_000_000
ANCHOR = trace.Anchor(wall_ns=WALL, perf_ns=0)
US = 1e-6


def _span(name, start_us, end_us, children=(), **attrs):
    return trace.Span(name, start_us * US, (end_us - start_us) * US, attrs,
                      list(children))


def _forward(at=0):
    """One forward from ``at``, times in us: a pool, a 3x3 conv (layer a,
    conv2d route), a 1x1 (layer b, act-stationary GEMM), the head."""
    sp = lambda name, a, b, children=(), **kw: _span(name, at + a, at + b,
                                                      children, **kw)
    return sp("cnn.forward", 0, 100, [
        sp("cnn.pool", 1, 6),
        sp("carla_conv", 10, 50, [
            sp("carla.plan", 11, 15),
            sp("kernels.conv2d", 16, 45, [
                sp("kernels.launch", 30, 40, route="conv2d")])],
           layer="a"),
        sp("carla_conv", 55, 90, [
            sp("carla.plan", 56, 58),
            sp("kernels.conv1x1", 60, 88, [
                sp("kernels.launch", 70, 80, route="mm_act_stationary")])],
           layer="b"),
        sp("cnn.head", 92, 98)])


def _op(start_us, end_us, launched_us, name="k"):
    ns = lambda us: None if us is None else WALL + int(us * 1000)
    return hostspans.DeviceOp(ns(start_us), ns(end_us), name,
                              ns(launched_us))


# the conv kernels launched inside their launch spans; the logits' copy has
# no runtime record; a kernel launched outside any launch span
OPS = [_op(35, 60, 32), _op(75, 85, 72), _op(99, 101, None, "copy"),
       _op(102, 104, 91, "head")]
WINDOW = (WALL, WALL + 110_000)
PEAK = {"flops_per_s": 1e12, "bytes_per_s": 1e12}
TABLE = [work.Op("a", "conv", 2_500_000, 0, 1000),       # 2.5 us
         work.Op("b", "conv", 5_000, 0, 10_000)]         # 0.01 us


def _passes(forwards=2):
    roots = [_forward() for _ in range(forwards)]
    return hostspans.Passes(forwards, [0.1] * forwards, roots, [_forward()],
                            ANCHOR, OPS, WINDOW)


def _reading(cell="resnet50.single_stream", profile=True):
    prof = devtrace.Profile(1, 1.0, 0.5, 4, {}, {}) if profile else None
    return harness.Reading(spec.cell(cell), TABLE, PEAK,
                           harness.Window(answers=None, enqueue_ms=[0.2]),
                           prof)


def test_innermost_spans_cover_the_forward_once():
    segs = hostspans.innermost([_forward()], ANCHOR)
    assert segs[0] == (WALL, WALL + 1000, "cnn.forward")
    assert [label for _, _, label in segs[:5]] == [
        "cnn.forward", "cnn.pool", "cnn.forward", "carla_conv", "carla.plan"]
    assert all(e0 == s1 for (_, e0, _), (s1, _, _) in zip(segs, segs[1:]))
    assert segs[-1][1] == WALL + 100_000


def test_device_idle_is_cut_by_the_innermost_host_span():
    idle = hostspans.idle_by_span(
        OPS[:3], hostspans.innermost([_forward()], ANCHOR), WINDOW)
    us = {k: v / 1000 for k, v in idle.items()}
    assert us == {"cnn.forward": 8, "cnn.pool": 5, "carla_conv": 4,
                  "carla.plan": 4, "kernels.conv2d": 14,
                  "kernels.launch": 10, "kernels.conv1x1": 13,
                  "cnn.head": 6, hostspans.NONE: 9}
    assert sum(us.values()) == 110 - 25 - 10 - 2     # the window less busy


def test_each_op_matches_the_launch_span_its_call_lies_in():
    matched = hostspans.matches([_forward()], ANCHOR, OPS)
    assert [(op.name, launch.attrs["route"], conv.attrs["layer"])
            for op, launch, conv in matched] == [
        ("k", "conv2d", "a"), ("k", "mm_act_stationary", "b")]


def _two(first_lead, second_lead, shift=0):
    """Two forwards' conv kernels (the second forward's 200 us later):
    each forward's first kernel ``*_lead`` us after its call, the device
    clock moved by ``shift`` us."""
    return [_op(at + 32 + lead + shift, at + 52 + lead + shift, at + 32)
            for at, lead in ((0, first_lead), (200, second_lead))] + [
        _op(at + 80 + shift, at + 84 + shift, at + 72) for at in (0, 200)]


SLIPPED = {
    "as recorded": (_two(3, 3), True),
    "the profile's first launch waiting for the profiler": (_two(600, 3),
                                                            True),
    "kernels 4 us before their calls": (_two(3, 3, shift=-7), False),
    "the second forward's first kernel 150 us late": (_two(3, 150), False),
}


@pytest.mark.parametrize("case", list(SLIPPED))
def test_a_profile_whose_device_clock_slipped_is_told(case):
    ops, ok = SLIPPED[case]
    roots = [_forward(), _forward(200)]
    assert hostspans.clock_ok(roots, ANCHOR, ops) is ok
    # a slipped clock leaves the idle split out of the summary, not the match
    p = hostspans.Passes(2, [0.1] * 2, roots, roots, ANCHOR, ops,
                         (WALL, WALL + 310_000), ok)
    summary = hostspans.summary(_reading(), p)
    assert (summary["idle_ms_by_host_span"] is None) is (not ok)
    assert summary["matched_kernels"] == 2


@pytest.mark.parametrize("route,want", [("conv2d", 10.0), ("conv1x1", 0.1)])
def test_a_route_roofline_is_its_least_time_over_its_kernels(route, want):
    matched = hostspans.matches([_forward()], ANCHOR, OPS)
    assert hostspans.route_roofline(TABLE, PEAK, matched, route) == \
        pytest.approx(want)
    # a dispatch the benchmark's table does not name reads nothing
    assert hostspans.route_roofline(TABLE[:0], PEAK, matched, route) is None


METRICS = {
    "host_plan_ms": ("resnet50.single_stream", 0.006),
    "host_prepare_ms": ("vgg16.single_stream", 0.037),
    "host_launch_ms": ("resnet50.single_stream", 0.020),
    "host_pool_head_ms": ("vgg16.single_stream", 0.011),
    "conv2d_roofline.offline": ("vgg16.offline", 10.0),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_each_reader_reads_the_passes(name, monkeypatch, capsys):
    cell, want = METRICS[name]
    runs = []
    monkeypatch.setattr(hostspans, "run",
                        lambda c: runs.append(c.name) or _passes())
    m = spec.metric(name)
    r = _reading(cell)
    assert m.reports(r.cell)
    assert m.read(r) == pytest.approx(want)
    assert m.read(r) == pytest.approx(want) and runs == [cell]  # once
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert '"idle_ms_by_host_span"' in line and '"host_spans"' in line


@pytest.mark.parametrize("name", list(METRICS))
def test_each_reader_reads_none_where_the_run_has_nothing(name,
                                                          monkeypatch):
    cell, _ = METRICS[name]
    m = spec.metric(name)
    # no device trace (no CUDA): no pass is run
    monkeypatch.setattr(hostspans, "run", lambda c: pytest.fail("ran"))
    assert m.read(_reading(cell, profile=False)) is None
    monkeypatch.undo()
    # a program without anchored spans: no pass either
    monkeypatch.setattr(tracing, "recorder", lambda: None)
    assert m.read(_reading(cell)) is None
    # passes with no matched kernel and no span of the metric's names
    empty = hostspans.Passes(1, [0.1], [_span("cnn.forward", 0, 1)],
                             [_span("cnn.forward", 0, 1)], ANCHOR, OPS[2:3],
                             WINDOW)
    monkeypatch.setattr(hostspans, "run", lambda c: empty)
    assert m.read(_reading(cell)) is None


def test_setup_load_sums_the_program_s_library_loads(monkeypatch):
    m = spec.metric("setup_load_s")
    assert m.scenarios == ("single_stream", "offline")
    loads = [_span("kernels.load", 0, 5e5, library="conv2d", built=False),
             _span("kernels.load", 0, 2.5e5, library="matmul", built=True)]
    monkeypatch.setattr(tracing, "library_loads", lambda: loads)
    assert m.read(_reading()) == pytest.approx(0.75)
    for nothing in ([], None):         # nothing loaded; no loads kept
        monkeypatch.setattr(tracing, "library_loads", lambda: nothing)
        assert m.read(_reading()) is None
