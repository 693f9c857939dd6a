"""Port parity: fused-epilogue descriptors, BN folding, structured sparsity.

The same numpy values go to ``repro.core`` and ``repro_torch.core``.  Masks
must come out bit-identical (stable argsort on L1 norms; the port sums the
norms in numpy float32), and the mask validation must raise the same errors.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fuse as j_fuse
from repro.core import sparsity as j_sp
from repro.core.networks import smoke_conv_layers
from repro_torch.core import fuse as t_fuse
from repro_torch.core import sparsity as t_sp


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------- fuse --------------------------------------
@pytest.mark.parametrize("parts", list(itertools.product((False, True),
                                                         repeat=4)))
def test_epilogue_tag_and_ops_match(parts):
    scale, bias, residual, relu = parts
    rng = np.random.default_rng(sum(p << i for i, p in enumerate(parts)))
    vals = {"scale": rng.standard_normal(4).astype(np.float32),
            "bias": rng.standard_normal(4).astype(np.float32),
            "residual": rng.standard_normal((2, 3, 3, 4)).astype(np.float32)}
    on = {"scale": scale, "bias": bias, "residual": residual}
    j_ep = j_fuse.Epilogue(relu=relu, **{n: jnp.asarray(v) if on[n] else None
                                         for n, v in vals.items()})
    t_ep = t_fuse.Epilogue(relu=relu, **{n: torch.from_numpy(v) if on[n]
                                         else None for n, v in vals.items()})
    assert t_ep.tag == j_ep.tag
    assert t_ep.n_fused_ops == j_ep.n_fused_ops
    assert t_ep.is_noop == j_ep.is_noop
    y = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    want = j_fuse.apply_epilogue(jnp.asarray(y), j_ep)
    got = t_fuse.apply_epilogue(torch.from_numpy(y), t_ep)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_fold_bn_matches():
    rng = np.random.default_rng(3)
    k = 16
    scale, bias, mean = (rng.standard_normal(k).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.1, 2.0, k).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, k)).astype(np.float32)
    j = j_fuse.fold_bn(*(jnp.asarray(a) for a in (scale, bias, mean, var)))
    t = t_fuse.fold_bn(*(torch.from_numpy(a) for a in (scale, bias, mean,
                                                      var)))
    for a, b in zip(j, t):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6)
    jw = j_fuse.fold_bn_into_conv(jnp.asarray(w), *(jnp.asarray(a) for a in
                                                   (scale, bias, mean, var)))
    tw = t_fuse.fold_bn_into_conv(torch.from_numpy(w),
                                  *(torch.from_numpy(a) for a in
                                    (scale, bias, mean, var)))
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6)


# ------------------------------- sparsity ------------------------------------
@pytest.mark.parametrize("shape", [(3, 3, 16, 64), (1, 1, 64, 256),
                                   (7, 7, 3, 64), (64, 32), (3, 3, 4, 6)])
@pytest.mark.parametrize("keep", [0.5, 0.25, 1 / 3, 1.0, 1e-9])
def test_topk_mask_bit_identical(shape, keep):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, shape[-1])
         ).astype(np.float32)
    want = j_sp.topk_channel_mask(jnp.asarray(w), keep)
    got = t_sp.topk_channel_mask(torch.from_numpy(w), keep)
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    np.testing.assert_allclose(t_sp.channel_importance(torch.from_numpy(w)),
                               np.asarray(j_sp.channel_importance(
                                   jnp.asarray(w))), rtol=1e-6)


def test_topk_mask_ties_keep_lowest_index():
    w = np.ones((1, 1, 4, 8), np.float32)
    assert np.array_equal(t_sp.topk_channel_mask(torch.from_numpy(w), 0.5),
                          j_sp.topk_channel_mask(jnp.asarray(w), 0.5))
    w2 = np.full((1, 1, 2, 6), 0.1, np.float32)
    w2[..., [0, 2, 5]] = 7.0
    got = t_sp.topk_channel_mask(torch.from_numpy(w2), 2 / 6)
    assert got.tolist() == [True, False, True, False, False, False]
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            t_sp.topk_channel_mask(torch.from_numpy(w), bad)


def test_prune_conv_weights_matches():
    w = np.arange(2 * 2 * 4 * 6, dtype=np.float32).reshape(2, 2, 4, 6)
    keep_in = np.array([True, False, True, False])
    keep_out = np.array([True] * 3 + [False] * 3)
    for kw in ({"keep_out": keep_out}, {"keep_in": keep_in},
               {"keep_out": keep_out, "keep_in": keep_in}):
        want = j_sp.prune_conv_weights(jnp.asarray(w), **kw)
        got = t_sp.prune_conv_weights(torch.from_numpy(w), **kw)
        assert got.is_contiguous()
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        want2 = j_sp.prune_conv_weights(jnp.asarray(w[0, 0]), **kw)
        got2 = t_sp.prune_conv_weights(torch.from_numpy(w[0, 0]), **kw)
        np.testing.assert_array_equal(_np(got2), np.asarray(want2))


BAD_MASKS = [
    (dict(keep_out=np.array([True, False])), ValueError, "does not match"),
    (dict(keep_in=np.ones(6, bool)), ValueError, "does not match"),
    (dict(keep_out=np.array([1, 0, 1, 0, 1, 0])), TypeError,
     "must be boolean"),
    (dict(keep_out=np.zeros(6, bool)), ValueError, "zero channels"),
]


@pytest.mark.parametrize("kw,exc,match", BAD_MASKS)
def test_mask_validation_errors_match(kw, exc, match):
    w = np.zeros((3, 3, 4, 6), np.float32)
    with pytest.raises(exc, match=match) as j_err:
        j_sp.prune_conv_weights(jnp.asarray(w), **kw)
    with pytest.raises(exc, match=match) as t_err:
        t_sp.prune_conv_weights(torch.from_numpy(w), **kw)
    assert str(t_err.value) == str(j_err.value)


def test_prune_bn_matches_and_validates():
    bn = {"scale": np.arange(4.0, dtype=np.float32),
          "bias": np.arange(4.0, dtype=np.float32) + 10}
    keep = np.array([True, False, True, False])
    got = t_sp.prune_bn({k: torch.from_numpy(v) for k, v in bn.items()}, keep)
    want = j_sp.prune_bn({k: jnp.asarray(v) for k, v in bn.items()}, keep)
    for k in bn:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    with pytest.raises(ValueError, match="does not match"):
        t_sp.prune_bn({k: torch.from_numpy(v) for k, v in bn.items()},
                      np.ones(3, bool))
    with pytest.raises(ValueError, match="inconsistent"):
        t_sp.prune_bn({"scale": torch.zeros(4), "bias": torch.zeros(5)}, keep)


def test_prune_plan_and_sparsity_tag_match():
    for args in (([64, 64, 256], [0.5, 0.5, 1.0], 3), ([8, 16], [1.0, 1.0], 4),
                 ([2], [0.1], 3)):
        assert t_sp.prune_plan(*args) == j_sp.prune_plan(*args)
    with pytest.raises(ValueError, match="must align"):
        t_sp.prune_plan([64, 128], [0.5], ic0=3)
    layer = smoke_conv_layers()[0]
    jt, tt = j_sp.SparsityTag(64, 64), t_sp.SparsityTag(64, 64)
    assert tt.keep_fraction(32, 32) == jt.keep_fraction(32, 32) == 0.25
    assert tt.dense_twin(layer) == jt.dense_twin(layer)
