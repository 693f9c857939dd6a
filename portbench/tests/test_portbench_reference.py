"""The plain reference and the benchmark's own count of the work.

The reference agrees with the port's plain path (``impl="ref"`` on the
CPU) on the same seeded weights, non-trivial BN included; the layer tables
count what the port's ``core/networks.py`` counts; the TF32 control reads
far above the program.
"""
import pytest
import torch

from portbench import spec
from portbench.archs import resnet_v1, vgg, work
from portbench.reference import common
from portbench.tests.conftest import tiny_config

ARCHS = {"resnet50": (resnet_v1, "resnet50_apply"),
         "vgg16": (vgg, "vgg16_apply")}


def _weights(name: str, seed: int):
    cfg = tiny_config(name)
    gen = torch.Generator().manual_seed(seed)
    arch = ARCHS[name][0]
    params = arch.draw(cfg, gen, "cpu")
    x = torch.randn((3, 32, 32, 3), generator=gen)
    return cfg, params, x


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reference_matches_the_ports_plain_path(name, seed):
    from repro_torch.models import cnn
    cfg, params, x = _weights(name, seed)
    c = spec.cell(f"{name}.single_stream")
    want = c.reference().forward(cfg, params, x)
    got = getattr(cnn, ARCHS[name][1])(params, x, impl="ref", fused=True)
    assert want.shape == (3, 10)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _bns(tree):
    if "scale" in tree:
        return [tree]
    return [bn for v in tree.values() if isinstance(v, dict)
            for bn in _bns(v)]


def test_bn_is_drawn_non_trivial():
    _, params, _ = _weights("resnet50", 3)
    bns = _bns(params)
    scales = torch.cat([bn["scale"] for bn in bns])
    biases = torch.cat([bn["bias"] for bn in bns])
    assert len(bns) == 53
    assert 0.5 <= scales.min() and scales.max() < 1.5 and scales.std() > 0.2
    assert -0.5 <= biases.min() and biases.max() < 0.5 and biases.std() > 0.2


def test_weights_repeat_from_the_seed_and_are_aligned():
    _, a, xa = _weights("vgg16", 5)
    _, b, xb = _weights("vgg16", 5)
    _, c, _ = _weights("vgg16", 6)
    assert all(torch.equal(a[k], b[k]) for k in a if k != "fc")
    assert torch.equal(xa, xb) and not torch.equal(a["g0_c0"], c["g0_c0"])
    base = a["g0_c0"].data_ptr()     # the CPU allocator aligns to 64 bytes
    assert all((t.data_ptr() - base) % 256 == 0 and t.is_contiguous()
               for k, t in a.items() if k != "fc")


def test_resnet50_counts_equal_the_ports_layer_tables():
    from repro_torch.core import networks
    cfg = spec.cell("resnet50.single_stream").config
    ops = {o.name: o for o in resnet_v1.layers(cfg, 1) if o.kind == "conv"}
    main = networks.resnet50_conv_layers()
    assert len(main) == 49 and len(ops) == 53
    for layer in main:
        assert ops[layer.name].macs == layer.dense_macs, layer.name
    proj = sum(o.macs for n, o in ops.items() if n.endswith("_proj"))
    assert proj == sum(
        l.dense_macs for l in networks.resnet50_projection_shortcuts())
    assert round(sum(l.dense_macs for l in main) / 1e9, 3) == 3.496
    assert round(proj / 1e9, 3) == 0.360


def test_vgg16_counts_equal_the_ports_layer_tables():
    from repro_torch.core import networks
    cfg = spec.cell("vgg16.single_stream").config
    convs = [o for o in vgg.layers(cfg, 1) if o.kind == "conv"]
    table = networks.vgg16_conv_layers()
    assert [o.macs for o in convs] == [l.dense_macs for l in table]
    assert round(sum(o.macs for o in convs) / 1e9, 3) == 15.347


@pytest.mark.parametrize("name", ["resnet50.offline", "vgg16.offline"])
def test_counts_scale_with_the_batch(name):
    c = spec.cell(name)
    one, many = (c.arch().layers(c.config, b) for b in (1, c.batch))
    assert [o.model_flops * c.batch for o in one] == \
        [o.model_flops for o in many]
    assert many[-1].model_flops == 2 * many[-1].macs


def test_bytes_read_each_input_once():
    # a strided 1x1 reads only the rows it samples; BN's vectors are fp32
    op, oh, ow = work.conv("c", 2, 56, 56, 256, 512, 1, 2, 0, bn=True,
                           residual=False, item=4)
    assert (oh, ow) == (28, 28)
    assert op.bytes == 4 * (2 * 28 * 28 * 256 + 256 * 512
                            + 2 * 28 * 28 * 512) + 4 * 2 * 512
    op, oh, ow = work.conv("c", 1, 56, 56, 64, 64, 3, 1, 1, bn=False,
                           residual=True, item=2)
    assert op.bytes == 2 * (56 * 56 * 64 + 9 * 64 * 64 + 2 * 56 * 56 * 64)
    op, oh, ow = work.pool("p", 1, 112, 112, 64, 3, 2, True, 4)
    assert (oh, ow) == (56, 56) and op.model_flops == 0
    assert op.bytes == 4 * 64 * (112 * 112 + 56 * 56)


def _inside(size, out, fl, stride, low):
    """(output, tap) pairs inside the input along both axes, counted by a
    convolution of ones over the input's ones padded with zeros."""
    high = max((out - 1) * stride + fl - size - low, 0)
    x = torch.nn.functional.pad(torch.ones(1, 1, size, size),
                                (low, high, low, high))
    y = torch.nn.functional.conv2d(x, torch.ones(1, 1, fl, fl),
                                   stride=stride)
    assert y.shape[-2:] == (out, out)
    return int(y.sum())


@pytest.mark.parametrize("size,fl,stride,pad", [
    (224, 7, 2, 3), (56, 3, 1, 1), (7, 3, 1, 1), (56, 1, 2, 0),
    (14, 3, 2, 1)])
def test_conv_operations_count_only_taps_inside_the_input(size, fl, stride,
                                                          pad):
    op, oh, ow = work.conv("c", 2, size, size, 8, 16, fl, stride, pad,
                           bn=True, residual=False, item=4)
    assert op.flops == 2 * 2 * 8 * 16 * _inside(size, oh, fl, stride, pad)
    assert op.model_flops == 2 * op.macs == 2 * 2 * oh * ow * 16 * fl**2 * 8
    if pad == 0:
        assert op.flops == op.model_flops


def test_a_3x3_on_a_7x7_map_needs_a_fifth_fewer_operations_than_it_pads():
    op, _, _ = work.conv("c", 1, 7, 7, 512, 512, 3, 1, 1, bn=True,
                         residual=False, item=4)
    assert op.flops / op.model_flops == pytest.approx(19 * 19 / 441)


@pytest.mark.parametrize("size,window,stride,same", [
    (112, 3, 2, True), (4, 3, 2, True), (224, 2, 2, False)])
def test_pool_operations_count_the_window_inside_the_input(size, window,
                                                           stride, same):
    op, oh, _ = work.pool("p", 1, size, size, 8, window, stride, same, 4)
    assert op.flops == 8 * (_inside(size, oh, window, stride, 0) - oh * oh)


def test_least_time_takes_the_slower_bound():
    ops = [work.Op("a", "conv", 100, 100, 10), work.Op("b", "pool", 1, 0, 50)]
    assert work.least_seconds(ops, 10.0, 10.0) == pytest.approx(10 + 5)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -3.0])
    assert common.round_tf32(x).tolist() == [1 + 2**-10, 1.0, 1 + 2**-9,
                                             -3.0]


def test_same_max_pool_pads_low_0_high_1_on_the_stem():
    x = torch.arange(16.0).view(1, 1, 4, 4)
    y = common.max_pool(x, 3, 2, same=True)
    assert y.shape == (1, 1, 2, 2)
    assert y.flatten().tolist() == [10.0, 11.0, 14.0, 15.0]
