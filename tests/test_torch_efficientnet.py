"""EfficientNetV2-S on the port's normal path (``models/efficientnet.py``).

On the CPU: the port's plain path (``impl="ref"``) against the benchmark's
plain reference (``portbench/reference/efficientnet_v2.py``) on seeded
weights at width 0.25 and 64 x 64; the depthwise conv's plain path against
``F.conv2d(groups=C)``; the squeeze-and-excitation gate and its pass
against their formulas, the gate kernel's order of summation in plain
PyTorch against the plain version, and which gates run its staged
instance; the SiLU epilogue's tag and order; which convs take a residual.

On the card (``chip``, skipped without one): the depthwise kernel at every
depthwise shape of the net, the SE kernel and its gate pass, and
``gemm_pipe.cuh``'s SiLU instance against their plain versions, fp32 and
bf16; every gate of an eager forward staged; a graph replay equal in bits
to the eager forward.

    PYTHONPATH=src python -m pytest -q tests/test_torch_efficientnet.py
"""
import json
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import autotune
from repro_torch.core.carla import carla_conv
from repro_torch.core.fuse import Epilogue, apply_epilogue
from repro_torch.core.modes import Dataflow
from repro_torch.kernels import dwconv as t_dw
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import se as t_se
from repro_torch.models import cnn_graph
from repro_torch.models import efficientnet as eff
from repro_torch.observability import trace

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" /
                     "efficientnetv2_s.json").read_text())
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def small_config(width: float = 0.25, size: int = 64) -> dict:
    """The configuration's structure at ``width`` (channels as
    ``efficientnet.blocks`` scales them) and ``size``."""
    w = lambda c: max(4, int(c * width))
    cfg = json.loads(json.dumps(CONFIG))
    cfg.update(image_size=size, num_classes=10,
               stem_channels=w(cfg["stem_channels"]),
               head_channels=w(cfg["head_channels"]))
    for st in cfg["stages"]:
        st.update({"in": w(st["in"]), "out": w(st["out"])})
    return cfg


def _weights(seed: int, width: float = 0.25, size: int = 64, batch: int = 2):
    from portbench.archs import efficientnet_v2 as arch
    cfg = small_config(width, size)
    gen = torch.Generator().manual_seed(seed)
    params = arch.draw(cfg, gen, "cpu")
    x = torch.randn((batch, size, size, 3), generator=gen)
    return cfg, params, x


# ------------------------------------------------------------ on the CPU ---
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_port_matches_the_reference(seed):
    from portbench.reference import efficientnet_v2 as reference
    cfg, params, x = _weights(seed)
    want = reference.forward(cfg, params, x)
    got = eff.efficientnetv2_s_apply(params, x, impl="ref")
    unfused = eff.efficientnetv2_s_apply(params, x, impl="ref", fused=False)
    assert want.shape == (2, 10)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
    assert (unfused - want).abs().max() <= 1e-5 * scale


def test_the_stage_table_is_the_configuration_s():
    assert [("fused" if st["fused"] else "mbconv", st["repeats"],
             st["kernel"], st["stride"], st["expand"], st["out"],
             st["se_ratio"]) for st in CONFIG["stages"]] == \
        [tuple(t) for t in eff.EFFNETV2_S]
    blocks = list(eff.blocks())
    assert len(blocks) == 40
    assert sum(b[1] == "mbconv" for b in blocks) == 30
    # the SE width is a quarter of the block's input, not of its expansion
    assert [b[7] for b in blocks if b[0] in ("s4_b0", "s4_b1", "s5_b0",
                                             "s6_b0", "s6_b1")] == \
        [16, 32, 32, 40, 64]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_depthwise_plain_path_matches_grouped_conv(k, stride):
    gen = torch.Generator().manual_seed(k * 10 + stride)
    x = torch.randn((2, 11, 9, 12), generator=gen)
    w = torch.randn((k, k, 1, 12), generator=gen)
    scale, bias = torch.rand(12, generator=gen), torch.rand(12, generator=gen)
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    stride=stride, padding=(k - 1) // 2, groups=12)
    want = F.silu(want * scale[:, None, None] + bias[:, None, None])
    want = want.permute(0, 2, 3, 1)
    oh, ow = want.shape[1:3]
    sums = torch.empty((2, t_dw.sum_tiles(oh, ow), 12))
    ep = Epilogue(scale=scale, bias=bias, silu=True, sums=sums)
    got = carla_conv(x, w, stride=stride, padding=(k - 1) // 2, epilogue=ep)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the tiles' sums: runs of TILE_PIX pixels, row-major, the last short
    flat = want.reshape(2, oh * ow, 12)
    for t in range(sums.shape[1]):
        part = flat[:, t * t_dw.TILE_PIX:(t + 1) * t_dw.TILE_PIX].sum(1)
        torch.testing.assert_close(sums[:, t], part, rtol=1e-5, atol=1e-5)


def test_depthwise_routes_its_own_way():
    d = autotune.decide((1, 24, 24, 960), (3, 3, 1, 960), 2, 1)
    assert (d.route, d.stationarity, d.entry, d.tiles) == (
        autotune.DWCONV, None, None, None)
    assert (d.rows, d.cols, d.reduction) == (144, 960, 9)
    # one input channel: an ordinary conv, whatever the filter's shape
    assert autotune.decide((1, 8, 8, 1), (3, 3, 1, 16), 1, 1).route == \
        autotune.CONV2D
    from repro_torch.core.carla import plan_conv
    plan = plan_conv((1, 24, 24, 960), (3, 3, 1, 960), 2, 1)
    assert plan.dataflow is Dataflow.DEPTHWISE and plan.cost is None
    assert autotune.tile_util(d, autotune.reference_plan(d, 960)) == 1.0


def test_depthwise_span_ledger_and_report_carry_no_analytic_cost():
    from repro_torch.observability import report
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 8, 8, 16), generator=gen)
    w = torch.randn((3, 3, 1, 16), generator=gen)
    with trace.capture() as cap:
        carla_conv(x, w, stride=2, padding=1, name="dw")
        carla_conv(x, torch.randn((16, 8), generator=gen), name="pw")
    a = cap.spans[0].attrs
    assert a["dataflow"] == "depthwise" and a["analytic_cycles"] is None
    assert a["macs"] == 4 * 4 * 16 * 9
    assert [s.name for s in cap.spans[0].walk()][:3] == [
        "carla_conv", "carla.plan", "kernels.dwconv"]
    rows = report.reconcile(cap.spans)
    assert rows[0].analytic_ms is None and rows[1].analytic_ms > 0
    assert report.totals(rows)["layers"] == 2
    assert "depthwise" in report.format_table(rows)


def test_se_gate_matches_its_formula():
    gen = torch.Generator().manual_seed(4)
    d = torch.randn((2, 5, 7, 24), generator=gen)
    w1, b1 = torch.randn((24, 6), generator=gen), torch.randn(6, generator=gen)
    w2, b2 = torch.randn((6, 24), generator=gen), torch.randn(24,
                                                               generator=gen)
    want = torch.sigmoid(F.silu(d.mean((1, 2)) @ w1 + b1) @ w2 + b2)
    sums = ref.tile_sums_ref(d, t_dw.TILE_PIX)
    assert sums.shape == (2, t_dw.sum_tiles(5, 7), 24)
    got = ops.se_gate(sums, 35, w1, b1, w2, b2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        t_se.se_gate(sums, 35, w1, b1, w2.t(), b2)


# (C, R) of every SE gate of the net, and a gate whose slices are uneven
SE_GATES = sorted({(b[3], b[7]) for b in eff.blocks() if b[1] == "mbconv"})
H100_SMEM_OPTIN = 232448     # bytes of shared memory a block may opt in to


def test_the_gate_constants_are_the_kernels():
    text = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
            "se.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (SE_CLUSTER|SE_THREADS) = (\d+);", text)}
    assert got == {"SE_CLUSTER": t_se.CLUSTER, "SE_THREADS": t_se.THREADS}
    assert SE_GATES == [(256, 16), (512, 32), (768, 32), (960, 40),
                        (1536, 64)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_gate_of_the_net_is_staged(dtype):
    dt = DTYPES[dtype]
    assert all(t_se.stages(c, r, dt, H100_SMEM_OPTIN) for c, r in SE_GATES)
    # C 1536, R 64 in fp32: a block's slices are 2 x 192 x 64 x 4 bytes
    assert t_se.smem_bytes(1536, 64, 4, True) == \
        t_se.smem_bytes(1536, 64, 4, False) + 2 * 192 * 64 * 4
    assert t_se.smem_bytes(1536, 64, 4, True) > 48 * 1024
    # a wide gate's slices do not fit: the same algorithm from memory
    assert not t_se.stages(3840, 160, torch.float32, H100_SMEM_OPTIN)
    assert not t_se.stages(3840, 160, torch.bfloat16, H100_SMEM_OPTIN)
    assert t_se.smem_bytes(3840, 160, 4, False) <= 48 * 1024


def _gate_by_slices(sums, npix, w1, b1, w2, b2):
    """The kernel's order of summation: each block's slice of channels
    gives a partial pre-activation of h, and the partials are added in the
    blocks' order, then b1."""
    c = sums.shape[-1]
    cc = -(-c // t_se.CLUSTER)
    mean = sums.sum(1) / npix
    pre = torch.zeros((sums.shape[0], w1.shape[1]))
    for r in range(t_se.CLUSTER):
        sl = slice(min(c, r * cc), min(c, (r + 1) * cc))
        pre = pre + mean[:, sl] @ w1[sl]
    return torch.sigmoid(F.silu(pre + b1) @ w2 + b2)


@pytest.mark.parametrize("c,r", SE_GATES + [(20, 3)])
def test_the_gates_order_of_summation_is_the_plain_versions(c, r):
    gen = torch.Generator().manual_seed(c + r)
    tiles = t_dw.sum_tiles(12, 12)
    sums = torch.randn((2, tiles, c), generator=gen) * 4
    w1 = torch.randn((c, r), generator=gen) / c ** .5
    w2 = torch.randn((r, c), generator=gen) / r ** .5
    b1 = torch.rand(r, generator=gen) - 0.5
    b2 = torch.rand(c, generator=gen) - 0.5
    got = _gate_by_slices(sums, 144, w1, b1, w2, b2)
    want = t_se.se_gate_plain(sums, 144, w1, b1, w2, b2)
    assert (got - want).abs().max().item() <= 1e-6


def test_se_pass_scales_the_map_by_image_and_channel():
    gen = torch.Generator().manual_seed(5)
    d = torch.randn((2, 3, 4, 8), generator=gen)
    gate = torch.rand((2, 8), generator=gen)
    got = ops.se_scale(d, gate)
    assert torch.equal(got[1, 2, 3], d[1, 2, 3] * gate[1])
    torch.testing.assert_close(got, d * gate[:, None, None, :], rtol=0,
                               atol=0)
    # bf16: one fp32 product rounded to bf16
    db = d.to(torch.bfloat16)
    assert torch.equal(ops.se_scale(db, gate),
                       (db.float() * gate[:, None, None, :]).bfloat16())
    with pytest.raises(ValueError):
        t_se.se_scale(d, gate[:1])


def test_silu_epilogue_tag_and_order():
    one = torch.ones(4)
    res = torch.full((1, 1, 1, 4), 3.0)
    ep = Epilogue(scale=one, bias=one, silu=True, residual=res)
    assert ep.tag == "scale+bias+silu+residual" and ep.n_fused_ops == 3
    assert Epilogue(relu=True).tag == "relu"
    assert Epilogue(scale=one, bias=one, silu=True, sums=one).tag == \
        "scale+bias+silu+sums"
    assert Epilogue(sums=one).tag == "sums" and not Epilogue(sums=one).is_noop
    with pytest.raises(ValueError):
        Epilogue(relu=True, silu=True)
    # SiLU first, then the shortcut: silu(-1 + 1) + 3 == 3
    y = apply_epilogue(torch.full((1, 1, 1, 4), -1.0), ep)
    assert torch.equal(y, torch.full((1, 1, 1, 4), 3.0))


def test_the_blocks_that_keep_their_shape_add_their_input():
    _, params, x = _weights(1, size=32, batch=1)
    with trace.capture() as cap:
        eff.efficientnetv2_s_apply(params, x, impl="ref")
    convs = [s for s in cap.spans[0].walk() if s.name == "carla_conv"]
    res = [s.attrs["layer"] for s in convs
           if "residual" in s.attrs["epilogue"]]
    want = (["s1_b0_conv", "s1_b1_conv"]
            + [f"s{s}_b{b}_project" for s, n in ((2, 4), (3, 4), (4, 6),
                                                 (5, 9), (6, 15))
               for b in range(1, n)])
    assert res == want and len(res) == 35
    assert len(convs) == 1 + 2 + 16 + 90 + 1
    dws = [s.attrs["layer"] for s in convs
           if s.attrs["layer"].endswith("_dw")]
    assert len(dws) == 30
    # each gate and its pass under its block's cnn.se span
    ses = [s for s in cap.spans[0].walk() if s.name == "cnn.se"]
    assert [s.attrs["layer"] for s in ses] == [
        d.replace("_dw", "_se") for d in dws]
    assert all([c.name for c in s.children] == [
        "kernels.se_gate", "kernels.se_scale"] for s in ses)
    assert {s.attrs["dataflow"] for s in convs
            if s.attrs["layer"].endswith("_dw")} == {"depthwise"}


def test_graph_counters_and_weight_walk():
    params = eff.efficientnetv2_s_init(torch.Generator().manual_seed(0),
                                       width=0.25, device="cpu")
    assert len(cnn_graph.weight_tensors(params)) == 452
    cnn_graph.reset(eff.efficientnetv2_s_apply)
    eff.efficientnetv2_s_apply(params, torch.randn((1, 32, 32, 3)))
    a = eff.efficientnetv2_s_apply
    assert (a.graph_captures, a.graph_replays, a.graph_eager["cpu"],
            a.graph_programmatic_edges, a.graph_cluster_kernels) == (
        0, 0, 1, 0, 0)


# ----------------------------------------------------------- on the card ---
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


# (input map, channels, stride) of every depthwise conv of the net at 384
DW_SHAPES = sorted({(h, c, s) for h, c, s in (
    (48, 256, 2), (24, 512, 1), (24, 768, 1), (24, 960, 1), (24, 960, 2),
    (12, 1536, 1))})


def test_the_card_shapes_are_the_nets():
    h, shapes = 384 // 2, set()
    for key, kind, cin, cexp, cout, k, s, _ in eff.blocks():
        if kind == "fused":
            h = (h - 1) // s + 1
            continue
        shapes.add((h, cexp, s))
        h = (h - 1) // s + 1
    assert sorted(shapes) == DW_SHAPES


def _close(got, want, dtype):
    """fp32: the sums' order alone; bf16: one bf16 step of the largest."""
    tol = (2e-6 if dtype == torch.float32 else 2.0 ** -7) \
        * want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,c,stride", DW_SHAPES)
def test_dwconv_kernel_matches_its_plain_version(cuda, h, c, stride, dtype):
    _no_tf32()
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(h * c + stride)
    x = torch.randn((1, h, h, c), generator=gen, device=cuda).to(dt)
    w = (torch.randn((3, 3, 1, c), generator=gen, device=cuda) / 3).to(dt)
    scale = torch.rand(c, generator=gen, device=cuda) + 0.5
    bias = torch.rand(c, generator=gen, device=cuda) - 0.5
    oh = (h - 1) // stride + 1
    sums = torch.empty((1, t_dw.sum_tiles(oh, oh), c), device=cuda)
    want_sums = torch.empty_like(sums)
    kw = dict(stride=stride, scale=scale, bias=bias, silu=True)
    before = t_dw.dwconv.launches
    got = t_dw.dwconv(x, w, sums=sums, **kw)
    again = t_dw.dwconv(x, w, sums=torch.empty_like(sums), **kw)
    want = t_dw.dwconv_plain(x, w, sums=want_sums, **kw)
    torch.cuda.synchronize()
    assert t_dw.dwconv.launches == before + 2
    assert torch.equal(got, again)
    _close(got, want, dt)
    _close(sums, want_sums, torch.float32 if dt == torch.float32 else dt)


@pytest.mark.chip
@pytest.mark.parametrize("k,c", [(5, 64), (7, 13), (3, 30)])
def test_dwconv_kernel_other_filters_and_the_scalar_path(cuda, k, c):
    _no_tf32()
    gen = torch.Generator(device="cuda").manual_seed(k * c)
    x = torch.randn((2, 19, 17, c), generator=gen, device=cuda)
    w = torch.randn((k, k, 1, c), generator=gen, device=cuda) / k
    for stride in (1, 2):
        got = t_dw.dwconv(x, w, stride=stride, relu=True)
        want = t_dw.dwconv_plain(x, w, stride=stride, relu=True)
        torch.cuda.synchronize()
        _close(got, want, torch.float32)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,c,r,pix", [(1, 256, 16, 576), (1, 960, 40, 144),
                                       (1, 1536, 64, 144), (3, 768, 32, 576),
                                       (2, 20, 3, 35), (1, 3840, 160, 144)])
def test_se_kernel_matches_its_plain_version(cuda, b, c, r, pix, dtype):
    _no_tf32()
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(c + r)
    tiles = t_dw.sum_tiles(1, pix)
    sums = torch.randn((b, tiles, c), generator=gen, device=cuda) * 4
    w1 = (torch.randn((c, r), generator=gen, device=cuda) / c ** .5).to(dt)
    w2 = (torch.randn((r, c), generator=gen, device=cuda) / r ** .5).to(dt)
    b1 = torch.rand(r, generator=gen, device=cuda) - 0.5
    b2 = torch.rand(c, generator=gen, device=cuda) - 0.5
    staged = t_se.se_gate.staged_launches
    got = t_se.se_gate(sums, pix, w1, b1, w2, b2)
    again = t_se.se_gate(sums, pix, w1, b1, w2, b2)
    want = t_se.se_gate_plain(sums, pix, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-5
    # the wide gate reads its weights from memory, every other stages them
    assert t_se.se_gate.staged_launches - staged == (0 if c == 3840 else 2)


# (output map, channels) of every SE gate pass of the net at 384, beside
# two batches and a channel count that takes the scalar path
SE_MAPS = [(24, 256, 1), (24, 512, 1), (24, 768, 1), (24, 960, 1),
           (12, 960, 1), (12, 1536, 1), (12, 1536, 3), (7, 30, 2)]


@pytest.mark.chip
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,c,b", SE_MAPS)
def test_se_scale_kernel_matches_its_plain_version(cuda, h, c, b, dtype):
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(h * c + b)
    d = torch.randn((b, h, h, c), generator=gen, device=cuda).to(dt)
    gate = torch.rand((b, c), generator=gen, device=cuda)
    want = t_se.se_scale_plain(d, gate)
    apart = t_se.scale_launch(d, gate, torch.empty_like(d))
    got = t_se.se_scale(d, gate)            # in place
    torch.cuda.synchronize()
    assert got.data_ptr() == d.data_ptr()
    assert torch.equal(apart, want) and torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("stationarity", ["as", "ws"])
def test_silu_gemm_instance(cuda, stationarity, dtype):
    _no_tf32()
    dt = DTYPES[dtype]
    st = (autotune.Stationarity.ACTIVATION_STATIONARY if stationarity == "as"
          else autotune.Stationarity.WEIGHT_STATIONARY)
    gen = torch.Generator(device="cuda").manual_seed(11)
    # two images whose rows share row tiles (144 rows each)
    x = torch.randn((2, 12, 12, 1536), generator=gen, device=cuda).to(dt)
    w = (torch.randn((1536, 256), generator=gen, device=cuda)
         / 40).to(dt)
    scale = torch.rand(256, generator=gen, device=cuda) + 0.5
    bias = torch.rand(256, generator=gen, device=cuda) - 0.5
    res = torch.randn((2, 12, 12, 256), generator=gen, device=cuda).to(dt)
    if st is autotune.Stationarity.WEIGHT_STATIONARY:
        x, res = x[:, :8, :8].contiguous(), res[:, :8, :8].contiguous()
    for kw in ({"silu": True}, {"silu": True, "residual": res}):
        got = t_mm.matmul(x, w, stationarity=st, scale=scale, bias=bias,
                          **kw)
        want = t_mm.matmul_plain(x, w, scale=scale, bias=bias, **kw)
        torch.cuda.synchronize()
        _close(got, want, dt)
    with pytest.raises(ValueError):
        t_mm.matmul(x, w, stationarity=st, silu=True, relu=True)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_silu_conv2d_instance(cuda, dtype):
    _no_tf32()
    dt = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(12)
    for cin, cout, h, s in ((3, 24, 384, 2), (24, 24, 192, 1),
                            (48, 192, 96, 1), (64, 256, 48, 2)):
        x = torch.randn((1, h, h, cin), generator=gen, device=cuda).to(dt)
        w = (torch.randn((3, 3, cin, cout), generator=gen, device=cuda)
             / (9 * cin) ** .5).to(dt)
        scale = torch.rand(cout, generator=gen, device=cuda) + 0.5
        bias = torch.rand(cout, generator=gen, device=cuda) - 0.5
        oh = (h - 1) // s + 1
        res = (torch.randn((1, oh, oh, cout), generator=gen, device=cuda)
               .to(dt) if s == 1 and cin == cout else None)
        kw = dict(stride=s, padding=1, scale=scale, bias=bias, silu=True,
                  residual=res)
        got = t_conv.conv2d(x, w, **kw)
        want = t_conv.conv2d_plain(x, w, **kw)
        torch.cuda.synchronize()
        _close(got, want, dt)


def _card_params(dtype, seed=0):
    from portbench.archs import efficientnet_v2 as arch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = arch.draw(CONFIG, gen, torch.device("cuda"))
    if dtype == torch.bfloat16:
        from portbench import harness
        params = harness._tree(lambda t: t.bfloat16() if t.dim() > 1 else t,
                               params)
    return params, gen


@pytest.mark.chip
def test_every_gate_of_an_eager_forward_runs_staged(cuda):
    params, gen = _card_params(torch.float32)
    x = torch.randn((1, 384, 384, 3), generator=gen, device=cuda)
    apply = eff.efficientnetv2_s_apply
    cnn_graph.reset(apply)
    before = (t_se.se_gate.launches, t_se.se_gate.staged_launches)
    apply(params, x)
    torch.cuda.synchronize()
    assert apply.graph_eager["new_key"] == 1
    assert (t_se.se_gate.launches - before[0],
            t_se.se_gate.staged_launches - before[1]) == (30, 30)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_replayed_logits_equal_eager_bits(cuda, dtype):
    dt = DTYPES[dtype]
    params, gen = _card_params(dt)
    apply = eff.efficientnetv2_s_apply
    xs = [torch.randn((1, 384, 384, 3), generator=gen, device=cuda).to(dt)
          for _ in range(3)]
    cnn_graph.reset(apply)
    got = [apply(params, x) for x in xs + xs]
    with trace.capture():
        want = [apply(params, x) for x in xs]
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got[3:], want))
    assert (apply.graph_eager["new_key"], apply.graph_captures,
            apply.graph_replays) == (1, 1, 5)
    assert apply.graph_programmatic_edges > 0


@pytest.mark.chip
def test_full_width_forward_matches_the_reference(cuda):
    from portbench.reference import efficientnet_v2 as reference
    _no_tf32()
    params, gen = _card_params(torch.float32, seed=5)
    x = torch.randn((2, 384, 384, 3), generator=gen, device=cuda)
    got = eff.efficientnetv2_s_apply(params, x)
    want = reference.forward(CONFIG, params, x)
    torch.cuda.synchronize()
    err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    assert err <= 2e-6, err
