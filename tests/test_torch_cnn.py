"""Port parity: ResNet-50 (fused, unfused, sparse) and VGG-16 forwards.

Both packages run the plain engine (``impl="ref"``) on the CPU at width
0.0625, batch 2 at 32x32 — small enough to be quick, and big enough that
both GEMM stationarities occur (conv2's 2*8*8 = 128 rows go
activation-stationary, conv5's 2 rows weight-stationary).  ResNet-50's
weights come from ``repro``'s initialiser with non-trivial BN drawn in
numpy, VGG-16's from the port's; either way they cross as numpy, through
``params_from_numpy``.  Tolerance: 1e-4 x max(1, max|logits|) in
fp32.  The ``carla_conv`` spans and their kernel spans must carry the same
ledger, layer by layer, with equal integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as j_cnn
from repro.observability import trace as j_trace
from repro_torch.models import cnn as t_cnn
from repro_torch.models.convert import params_from_numpy, tree_map
from repro_torch.observability import trace as t_trace


def _randomize_bn(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict) and "scale" in v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(
                np.float32)
            v["bias"] = rng.uniform(-0.5, 0.5, v["bias"].shape).astype(
                np.float32)
        elif isinstance(v, dict):
            _randomize_bn(v, rng)


@pytest.fixture(scope="module")
def resnet():
    tree = jax.tree_util.tree_map(
        np.asarray, j_cnn.resnet50_init(jax.random.PRNGKey(0), width=0.0625,
                                        num_classes=10))
    _randomize_bn(tree, np.random.default_rng(7))
    x = np.random.default_rng(11).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"), x)


@pytest.fixture(scope="module")
def vgg():
    # drawn by the port's initialiser (a seeded torch.Generator) this time;
    # either package's weights cross the same way, as numpy
    tree = tree_map(lambda t: t.numpy(),
                    t_cnn.vgg16_init(torch.Generator().manual_seed(2),
                                     width=0.0625, num_classes=10,
                                     device="cpu"))
    x = np.random.default_rng(13).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"), x)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-4 * scale


VARIANTS = {"fused": {}, "unfused": {"fused": False},
            "sparse": {"sparse": True},
            "sparse_unfused": {"sparse": True, "fused": False},
            "keep_dict": {"keep_fractions": {"conv3": 0.5, "conv5": 0.25}}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resnet50_forward_matches(resnet, variant):
    jp, tp, x = resnet
    kw = VARIANTS[variant]
    want = j_cnn.resnet50_apply(jp, jnp.asarray(x), impl="ref", **kw)
    got = t_cnn.resnet50_apply(tp, torch.from_numpy(x), impl="ref", **kw)
    _close(got, want)


def test_resnet50_prune_masks_bit_identical(resnet):
    jp, tp, _ = resnet
    j_pruned, j_masks = j_cnn.resnet50_prune(jp, 0.5)
    t_pruned, t_masks = t_cnn.resnet50_prune(tp, 0.5)
    assert set(j_masks) == set(t_masks)
    for name, (m1, m2) in j_masks.items():
        assert np.array_equal(t_masks[name][0], m1)
        assert np.array_equal(t_masks[name][1], m2)
        for c in ("c1", "c2", "c3"):
            np.testing.assert_array_equal(t_pruned[name][c].numpy(),
                                          np.asarray(j_pruned[name][c]))


@pytest.mark.parametrize("fused", [True, False])
def test_vgg16_forward_matches(vgg, fused):
    jp, tp, x = vgg
    want = j_cnn.vgg16_apply(jp, jnp.asarray(x), impl="ref", fused=fused)
    got = t_cnn.vgg16_apply(tp, torch.from_numpy(x), impl="ref", fused=fused)
    _close(got, want)


CARLA_KEYS = ("layer", "dataflow", "epilogue", "x_shape", "w_shape", "stride",
              "padding", "batch", "macs", "dense_macs", "analytic_cycles",
              "analytic_dram_bytes", "bytes_touched", "epilogue_hbm_saved",
              "pruned", "keep_fraction", "dense_twin_macs")
FLOAT_KEYS = ("analytic_time_ms", "analytic_puf")
KERNEL_KEYS = ("flops", "bytes_touched", "epilogue", "epilogue_hbm_saved",
               "stride", "padding", "stationarity", "x_shape", "w_shape")


def _spans(capture, name="carla_conv"):
    return [s for root in capture.spans for s in root.walk()
            if s.name == name]


@pytest.mark.parametrize("variant", ["fused", "sparse", "unfused"])
def test_resnet50_spans_match(resnet, variant):
    jp, tp, x = resnet
    kw = VARIANTS[variant]
    with j_trace.capture() as j_tr:
        j_cnn.resnet50_apply(jp, jnp.asarray(x), impl="ref", **kw)
    with t_trace.capture() as t_tr:
        t_cnn.resnet50_apply(tp, torch.from_numpy(x), impl="ref", **kw)
    j_sp, t_sp = _spans(j_tr), _spans(t_tr)
    assert len(j_sp) == len(t_sp) == 53
    stationarities = set()
    for js, ts in zip(j_sp, t_sp):
        for key in CARLA_KEYS:
            assert ts.attrs.get(key) == js.attrs.get(key), (js.attrs["layer"],
                                                            key)
        for key in FLOAT_KEYS:
            assert ts.attrs[key] == pytest.approx(js.attrs[key], rel=1e-12)
        assert ts.attrs["effective_dataflow"] == js.attrs["dataflow"]
        (jk,), (tk,) = js.children, ts.children
        assert tk.name == jk.name
        assert tk.attrs["impl"] == "ref"
        for key in KERNEL_KEYS:
            assert tk.attrs.get(key) == jk.attrs.get(key), (js.attrs["layer"],
                                                            key)
        stationarities.add(tk.attrs.get("stationarity"))
    assert {"activation_stationary", "weight_stationary"} <= stationarities


def test_vgg16_spans_match(vgg):
    jp, tp, x = vgg
    with j_trace.capture() as j_tr:
        j_cnn.vgg16_apply(jp, jnp.asarray(x), impl="ref")
    with t_trace.capture() as t_tr:
        t_cnn.vgg16_apply(tp, torch.from_numpy(x), impl="ref")
    j_sp, t_sp = _spans(j_tr), _spans(t_tr)
    assert len(j_sp) == len(t_sp) == 13
    for js, ts in zip(j_sp, t_sp):
        for key in CARLA_KEYS:
            assert ts.attrs.get(key) == js.attrs.get(key), key
        (jk,), (tk,) = js.children, ts.children
        for key in KERNEL_KEYS:
            assert tk.attrs.get(key) == jk.attrs.get(key), key


def test_params_from_numpy_keeps_keys_and_values(resnet):
    jp, tp, _ = resnet
    leaves_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(leaves_j) == len(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tp)))
    np.testing.assert_array_equal(tp["conv3_b0"]["c2"].numpy(),
                                  np.asarray(jp["conv3_b0"]["c2"]))
    half = params_from_numpy({"a": {"b": np.ones(3, np.float32)}},
                             device="cpu", dtype=torch.bfloat16)
    assert half["a"]["b"].dtype == torch.bfloat16


def test_maxpool_same_matches_reduce_window():
    """The stem pool pads like XLA's SAME (low 0, high 1 at even sizes)."""
    for n in (112, 16, 15):
        x = np.random.default_rng(n).standard_normal((1, n, n, 4)).astype(
            np.float32)
        want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                     (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
        got = t_cnn._max_pool(torch.from_numpy(x), 3, 2, same=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
