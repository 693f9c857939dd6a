"""Port parity: the MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs and weights.

What ``repro`` routes is read from its own dispatch and combine tensors,
caught at its ``jnp.einsum`` calls; the port's come from ``moe._route``.
Tolerances:

* routing: identical.  The same experts chosen and the same tokens dropped
  (the combine tensors' nonzero pattern equal exactly), with a capacity
  factor of 0.5 that drops tokens, and exact router ties broken to the
  lowest expert index as ``lax.top_k`` does.  Gate values: fp32 1e-6 (both
  compute the router and its softmax in fp32), bf16 one bf16 step, 2^-8.
* outputs, fp32: 1e-5·max(1, max|ref|) (fp32 products summed in another
  order); bf16: 2e-2·max(1, max|ref|) (the expert products round to bf16
  in different summation orders).
* aux loss: 1e-6 relative (fp32 means of the same probabilities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import with_compute_copies

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D, DFF, E = 32, 48, 4


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _scale(a) -> float:
    return max(1.0, float(np.max(np.abs(_f32(a)))))


def _params(seed=0, zero_router=False):
    p = jax.tree_util.tree_map(
        np.asarray, j_moe.moe_init(jax.random.PRNGKey(seed), E, D, DFF))
    if zero_router:                        # every router logit 0: all tie
        p["router"] = np.zeros_like(p["router"])
    return p


class _Spy:
    """Stands in for ``jnp`` in ``repro.models.moe``: records the operands
    of every einsum by its spec."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        self.calls[spec] = ops
        return jnp.einsum(spec, *ops, **kw)


def _run_both(monkeypatch, p, x, dtype, *, top_k, cf, groups=1):
    """(repro y, aux, combine), (port y, aux, combine) for x (B, T, d)."""
    jd, td = DT[dtype]
    spy = _Spy()
    monkeypatch.setattr(j_moe, "jnp", spy)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p, device="cpu")
    b, t, d = x.shape
    if groups == 1:
        jy, jaux = j_moe._moe_flat(jp, jnp.asarray(x, jd), top_k=top_k,
                                   capacity_factor=cf)
        jcomb = spy.calls["btec,becd->btd"][0]
        tx = torch.from_numpy(x).to(td)
        ty, taux = t_moe.moe_ffn(tp, tx, top_k=top_k, capacity_factor=cf)
        _, _, tcomb = t_moe._route(tp, tx, top_k, cf, 1)
    else:
        xg = x.reshape(b, groups, t // groups, d)
        jy, jaux = j_moe._moe_grouped(jp, jnp.asarray(xg, jd), top_k=top_k,
                                      capacity_factor=cf)
        jy = jy.reshape(b, t, d)
        jcomb = spy.calls["bstec,bsecd->bstd"][0]
        tx = torch.from_numpy(x).to(td)
        ty, taux = t_moe.moe_ffn(tp, tx, top_k=top_k, capacity_factor=cf,
                                 groups=groups)
        _, _, tcomb = t_moe._route(tp, tx.reshape(b, groups, t // groups, d),
                                   top_k, cf, 2)
    return (jy, jaux, jcomb), (ty, taux, tcomb)


def _check(j, t, dtype, b, tokens, top_k, *, expect_drops=False):
    (jy, jaux, jcomb), (ty, taux, tcomb) = j, t
    jc, tc = _f32(jcomb), _f32(tcomb)
    assert jc.shape == tc.shape
    assert np.array_equal(jc > 0, tc > 0)          # same choices and drops
    kept = int((tc > 0).sum())
    assert kept <= b * tokens * top_k
    if expect_drops:
        assert kept < b * tokens * top_k
    gate_tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert np.max(np.abs(jc - tc)) <= gate_tol
    assert ty.dtype == DT[dtype][1] and tuple(ty.shape) == jy.shape
    tol = (1e-5 if dtype == "float32" else 2e-2) * _scale(jy)
    assert np.max(np.abs(_f32(ty) - _f32(jy))) <= tol
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("top_k,cf", [(2, 8.0), (2, 0.5), (1, 1.25),
                                      (1, 0.5)])
@pytest.mark.parametrize("dtype", list(DT))
def test_moe_flat_matches_repro(monkeypatch, top_k, cf, dtype):
    x = np.random.default_rng(1).standard_normal((2, 16, D)).astype(
        np.float32)
    j, t = _run_both(monkeypatch, _params(), x, dtype, top_k=top_k, cf=cf)
    _check(j, t, dtype, 2, 16, top_k, expect_drops=cf == 0.5)


@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (2, 0.5), (1, 0.5)])
@pytest.mark.parametrize("dtype", list(DT))
def test_moe_grouped_matches_repro(monkeypatch, top_k, cf, dtype):
    x = np.random.default_rng(2).standard_normal((2, 24, D)).astype(
        np.float32)
    j, t = _run_both(monkeypatch, _params(1), x, dtype, top_k=top_k, cf=cf,
                     groups=3)
    _check(j, t, dtype, 2, 24, top_k, expect_drops=cf == 0.5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_take_the_lowest_expert(monkeypatch, top_k):
    """All logits equal: ``lax.top_k`` takes experts 0..k-1, and so must the
    port (``torch.topk`` promises no order on ties)."""
    x = np.random.default_rng(3).standard_normal((1, 8, D)).astype(
        np.float32)
    j, t = _run_both(monkeypatch, _params(2, zero_router=True), x,
                     "float32", top_k=top_k, cf=8.0)
    _check(j, t, "float32", 1, 8, top_k)
    chosen = (_f32(t[2]) > 0).any(axis=-1)         # (B, T, E)
    assert chosen[..., :top_k].all() and not chosen[..., top_k:].any()


def test_moe_ffn_takes_the_flat_path_as_repro_without_a_mesh():
    p = _params(4)
    x = np.random.default_rng(4).standard_normal((2, 12, D)).astype(
        np.float32)
    jy, jaux = j_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p),
                             jnp.asarray(x, jnp.bfloat16), top_k=2)
    ty, taux = t_moe.moe_ffn(params_from_numpy(p, device="cpu"),
                             torch.from_numpy(x).to(torch.bfloat16), top_k=2)
    assert np.max(np.abs(_f32(ty) - _f32(jy))) <= 2e-2 * _scale(jy)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_expert_copies_change_nothing():
    """The bf16 copies of the stacked experts hold the per-call cast's
    values: the same output bits with and without them."""
    plain = params_from_numpy(_params(5), device="cpu")
    held = with_compute_copies(plain)
    for name in ("wi", "wg", "wo"):
        assert held[name + "_c"].dtype == torch.bfloat16
        assert torch.equal(held[name + "_c"], plain[name].to(torch.bfloat16))
    x = torch.randn(2, 6, D, generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    y0, _ = t_moe.moe_ffn(plain, x, top_k=2)
    y1, _ = t_moe.moe_ffn(held, x, top_k=2)
    assert torch.equal(y0, y1)
