"""The EfficientNetV2-S configuration: its work table against a count of
its own, the plain reference's independence from the program, the limit
against faults planted in the program's plain path, and the two readers of
the depthwise and SE kernels' device time (``routeshare.py``) on a
synthetic forward whose every number is known."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import check, devtrace, harness, hostspans, routeshare, spec
from portbench.archs import efficientnet_v2 as arch
from portbench.archs import work
from repro_torch.observability import trace

CELL = "efficientnetv2_s.single_stream"


def _cfg(width: float = 0.25, size: int = 64) -> dict:
    """The configuration's structure, channels at ``width`` as the port's
    ``efficientnet.blocks`` scales them, 10 classes."""
    w = lambda c: max(4, int(c * width))
    cfg = json.loads(json.dumps(spec.cell(CELL).config))
    cfg.update(image_size=size, num_classes=10,
               stem_channels=w(cfg["stem_channels"]),
               head_channels=w(cfg["head_channels"]))
    for st in cfg["stages"]:
        st.update({"in": w(st["in"]), "out": w(st["out"])})
    return cfg


def _count(cfg: dict) -> tuple[int, int]:
    """(parameters, multiply-adds an image) from the equations, by hand:
    BN's scale and bias, the SE and fc biases counted as parameters."""
    s = cfg["image_size"]
    h = (s - 1) // 2 + 1
    params = 9 * 3 * 24 + 2 * 24
    macs = h * h * 9 * 3 * 24
    cin = 24
    for st in cfg["stages"]:
        for b in range(st["repeats"]):
            c = cin if b == 0 else st["out"]
            stride = st["stride"] if b == 0 else 1
            e, out = c * st["expand"], st["out"]
            oh = (h - 1) // stride + 1
            if st["fused"] and st["expand"] == 1:
                params += 9 * c * out + 2 * out
                macs += oh * oh * 9 * c * out
            elif st["fused"]:
                params += 9 * c * e + 2 * e + e * out + 2 * out
                macs += oh * oh * (9 * c * e + e * out)
            else:
                r = int(c * st["se_ratio"])
                params += (c * e + 2 * e + 9 * e + 2 * e + 2 * e * r + r + e
                           + e * out + 2 * out)
                macs += h * h * c * e + oh * oh * (9 * e + e * out) + 2 * e * r
            h = oh
        cin = st["out"]
    params += 256 * 1280 + 2 * 1280 + 1280 * 1000 + 1000
    macs += h * h * 256 * 1280 + 1280 * 1000
    return params, macs


def test_work_table_counts_the_published_network():
    cfg = spec.cell(CELL).config
    params, macs = _count(cfg)
    assert (params, macs) == (21_458_488, 8_365_617_152)
    ops = arch.layers(cfg, 1)
    assert sum(o.macs for o in ops) == macs
    assert sum(2 * o.macs for o in ops) == sum(o.model_flops for o in ops)
    assert len([o for o in ops if o.kind == "conv"]) == 80
    assert len([o for o in ops if o.kind == "dwconv"]) == 30
    assert len([o for o in ops if o.name.endswith("_se.mean")]) == 30
    # the weights drawn hold as many numbers as the count
    from repro_torch.models import cnn_graph
    drawn = cnn_graph.weight_tensors(
        arch.draw(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert len(drawn) == 452
    assert sum(t.numel() for t in drawn) == params


def test_depthwise_and_se_ops_count_their_work():
    op, oh, ow = arch.dwconv("d", 1, 48, 48, 256, 3, 2, 4)
    assert (oh, ow) == (24, 24)
    assert op.macs == 24 * 24 * 256 * 9
    # the taps inside the input: 47 full windows of 3 a row, the first 2
    assert op.flops == 2 * 256 * (23 * 3 + 2) ** 2
    assert op.bytes == 4 * (48 * 48 * 256 + 9 * 256 + 24 * 24 * 256) \
        + 8 * 256
    # with the tile sums: an add an output, 36 tiles of 16 pixels written
    summed, _, _ = arch.dwconv("d", 1, 48, 48, 256, 3, 2, 4, sums=True)
    assert summed.flops == op.flops + 24 * 24 * 256
    assert summed.bytes == op.bytes + 4 * 36 * 256
    assert summed.macs == op.macs
    mean, fc1, fc2, scale = arch.se_ops("b_se", 1, 24, 24, 960, 40, 4)
    assert [o.name for o in (mean, fc1, fc2, scale)] == [
        "b_se.mean", "b_se.fc1", "b_se.fc2", "b_se.scale"]
    # the pass reads and writes the map and reads the gate
    assert scale.bytes == 4 * (2 * 24 * 24 * 960 + 960)
    # the mean reads the 36 tiles' fp32 sums, not the map
    assert (mean.flops, mean.bytes) == (36 * 960, 4 * 36 * 960)
    assert (fc1.macs, fc2.macs) == (960 * 40, 40 * 960)
    assert fc1.bytes == 4 * (960 + 960 * 40 + 40) + 4 * 40


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json, torch\n"
            "from portbench.reference import efficientnet_v2 as r\n"
            "from portbench.archs import efficientnet_v2 as a\n"
            "cfg = json.loads(sys.argv[1])\n"
            "p = a.draw(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
            "r.forward(cfg, p, torch.randn(1, 32, 32, 3))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib')]\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code,
                          json.dumps(_cfg(size=32))],
                         cwd=spec.ROOT.parent, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    text = (spec.ROOT / "reference" / "efficientnet_v2.py").read_text()
    imports = [ln for ln in text.splitlines()
               if ln.startswith(("import ", "from "))]
    assert imports and not any("repro" in ln or "jax" in ln
                               for ln in imports)


def _errors(seed=3):
    """The widest logit error of the program's plain path (with a planted
    fault) against the reference, as a run's check computes it."""
    from repro_torch.models import efficientnet
    cfg = _cfg()
    gen = torch.Generator().manual_seed(seed)
    params = arch.draw(cfg, gen, "cpu")
    x = torch.randn((2, 64, 64, 3), generator=gen)
    want = spec.cell(CELL).reference().forward(cfg, params, x)
    got = efficientnet.efficientnetv2_s_apply(params, x, impl="ref")
    return float(check.image_errors(got[None], 1, want, 2).max())


def _shifted(fn):
    """A 3x3 conv's plain version that pads a stride-2 conv as SAME does on
    an even map (low 0, high 1) in place of 1 on each side: the same
    shapes, each window shifted by one (the input moved up and left by one
    pixel, a zero row and column after it)."""
    def faulty(x, w, stride=1, *args, **kw):
        if stride == 2:
            x = torch.nn.functional.pad(x, (0, 0, 0, 1, 0, 1))[:, 1:, 1:]
        return fn(x, w, stride, *args, **kw)
    return faulty


def test_the_limit_catches_planted_faults(monkeypatch):
    from repro_torch.kernels import conv2d as t_conv
    from repro_torch.kernels import dwconv as t_dw
    from repro_torch.kernels import ref
    from repro_torch.models import efficientnet
    limit = spec.cell(CELL).limits["logit_err"]
    assert _errors() < limit / 10
    with monkeypatch.context() as m:       # the SE gate skipped
        m.setattr(efficientnet, "_se", lambda p, d, sums, impl, name: d)
        assert _errors() > 10 * limit
    with monkeypatch.context() as m:       # ReLU in place of SiLU
        orig = ref.epilogue_ref
        m.setattr(ref, "epilogue_ref",
                  lambda y, scale=None, bias=None, relu=False, residual=None,
                  silu=False: orig(y, scale, bias, relu or silu, residual))
        assert _errors() > 10 * limit
    with monkeypatch.context() as m:       # stride-2 windows shifted by one
        m.setattr(t_conv, "conv2d_ref", _shifted(ref.conv2d_ref))
        m.setattr(t_dw, "dwconv_ref", _shifted(ref.dwconv_ref))
        assert _errors() > 10 * limit


# ------------------------------------------------ the two readers, synthetic
WALL = 1_790_000_000_000_000_000
ANCHOR = trace.Anchor(wall_ns=WALL, perf_ns=0)
US = 1e-6
PEAK = {"flops_per_s": 1e12, "bytes_per_s": 1e12}
TABLE = [work.Op("b_expand", "conv", 1000, 0, 1000),
         work.Op("b_dw", "dwconv", 100, 0, 2_000_000),         # 2 us
         work.Op("b_se.mean", "mean", 10, 0, 300_000),          # 0.3 us
         work.Op("b_se.fc1", "fc", 10, 0, 100_000),             # 0.1 us
         work.Op("b_se.fc2", "fc", 10, 0, 100_000),             # 0.1 us
         work.Op("b_se.scale", "scale", 10, 0, 400_000),        # 0.4 us
         work.Op("b_project", "conv", 1000, 0, 1000)]


def _span(name, a, b, children=(), **attrs):
    return trace.Span(name, a * US, (b - a) * US, attrs, list(children))


def _block():
    """One MBConv block, times in us: its depthwise conv (layer b_dw), its
    SE gate and gate pass under cnn.se (layer b_se), its projection."""
    return _span("cnn.forward", 0, 100, [
        _span("carla_conv", 10, 30, [
            _span("kernels.dwconv", 12, 28, [
                _span("kernels.launch", 20, 25, route="dwconv")])],
              layer="b_dw"),
        _span("cnn.se", 31, 54, [
            _span("kernels.se_gate", 32, 48, [
                _span("kernels.launch", 40, 45, route="se")]),
            _span("kernels.se_scale", 48, 53, [
                _span("kernels.launch", 49, 50, route="se_scale")])],
              layer="b_se"),
        _span("carla_conv", 55, 90, [
            _span("kernels.conv1x1", 60, 88, [
                _span("kernels.launch", 70, 80,
                      route="mm_act_stationary")])],
              layer="b_project")])


def _op(start, end, launched):
    ns = lambda us: WALL + int(us * 1000)
    return hostspans.DeviceOp(ns(start), ns(end), "k", ns(launched))


OPS = [_op(30, 34, 22), _op(50, 55, 41), _op(56, 58, 49.5),
       _op(85, 95, 72)]


def test_the_readers_share_the_matched_launches():
    launches = routeshare.owned_launches([_block()], ANCHOR, "carla_conv")
    assert [l[2].attrs["route"] for l in launches] == [
        "dwconv", "se", "se_scale", "mm_act_stationary"]
    assert launches[1][3] is None               # no carla_conv around SE
    # 2 us of least time over 4 us of kernel
    assert routeshare.share(TABLE, PEAK, OPS, launches, ("dwconv",)) == \
        pytest.approx(50.0)
    se = routeshare.owned_launches([_block()], ANCHOR, "cnn.se")
    # the mean, both fcs and the pass, 0.9 us once, over 5 + 2 us
    assert routeshare.share(TABLE, PEAK, OPS, se, ("se", "se_scale")) == \
        pytest.approx(90 / 7)
    # a layer the table does not name reads None, as does a route no
    # launch took
    assert routeshare.share(TABLE[:1], PEAK, OPS, launches,
                            ("dwconv",)) is None
    assert routeshare.share(TABLE, PEAK, OPS, launches, ("conv2d",)) is None
    assert routeshare.share(TABLE, PEAK, [], launches, ("dwconv",)) is None


def _reading(profile: bool):
    prof = devtrace.Profile(1, 1.0, 0.5, 3, {}, {}) if profile else None
    return harness.Reading(spec.cell(CELL), TABLE, PEAK,
                           harness.Window(answers=None, enqueue_ms=[0.2]),
                           prof)


@pytest.mark.parametrize("name", ["dwconv_roofline.single_stream",
                                  "se_roofline.single_stream"])
def test_the_metrics_read_the_passes_and_none_without(monkeypatch, name):
    m = spec.metric(name)
    assert m.reports(spec.cell(CELL)) and m.unit == "%"
    passes = hostspans.Passes(1, [0.1], [_block()], [_block()], ANCHOR, OPS,
                              (WALL, WALL + 110_000))
    r = _reading(True)
    monkeypatch.setattr(hostspans, "_last", [(r, passes)])
    assert m.read(r) == pytest.approx(50.0 if "dwconv" in name else 90 / 7)
    # launches on the route that no device op matched read None
    plain = hostspans.Passes(1, [0.1], [_block()], [_block()], ANCHOR,
                             OPS[3:], (WALL, WALL + 110_000))
    r2 = _reading(True)
    monkeypatch.setattr(hostspans, "_last", [(r2, plain)])
    assert m.read(r2) is None
    # a forward that launches nothing on the route (a ResNet's) reads 0.0
    resnet = _span("cnn.forward", 0, 100, _block().children[2:])
    dense = hostspans.Passes(1, [0.1], [resnet], [resnet], ANCHOR, OPS[3:],
                             (WALL, WALL + 110_000))
    r3 = _reading(True)
    monkeypatch.setattr(hostspans, "_last", [(r3, dense)])
    assert m.read(r3) == 0.0
    # a program without the route (the parent's) reads None, not 0.0
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "ROUTES", {
        k: v for k, v in _build.ROUTES.items()
        if k not in ("dwconv", "se", "se_scale")})
    assert m.read(r3) is None
    monkeypatch.undo()
    # without a device trace (the CPU) or without the program's spans
    assert m.read(_reading(False)) is None
