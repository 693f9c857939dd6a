"""Port parity: RWKV-6 (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same numpy inputs and weights.

Tolerances:

* ``_wkv_chunked`` (fp32 inputs): 1e-3·max(1, max|ref|).  Both round the
  chunked einsums' operands to bf16 and accumulate in fp32; an exp that
  differs by one fp32 ulp between the two libraries can move one operand by
  one bf16 step (2^-8 relative), which the fp32 products then carry.
* time mix (chunked and per-token), channel mix and the token shift, bf16
  activations: 2e-2·max(1, max|ref|), as the other bf16 layers
  (``tests/test_torch_lm.py``): the projections round to bf16 in different
  summation orders, and the token shift is one fp32 sum rounded once where
  ``repro`` rounds a bf16 lerp.  The carried state (fp32) to the same
  relative bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import perf
from repro.models import ssm as j_ssm
from repro_torch import perf as t_perf
from repro_torch.kernels import conv1d as t_conv1d
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import params_from_numpy

D, H = 64, 4
DH = D // H


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _err(got, want) -> float:
    return float(np.max(np.abs(_f32(got) - _f32(want))))


def _scale(want) -> float:
    return max(1.0, float(np.max(np.abs(_f32(want)))))


def _params(seed=0):
    p = jax.tree_util.tree_map(
        np.asarray, j_ssm.rwkv6_init(jax.random.PRNGKey(seed), D, H,
                                     d_ff=96))
    rng = np.random.default_rng(seed)
    # lerps and decays off their constant defaults, so each is exercised
    for name in ("mu_x", "mu_c"):
        p[name] = rng.uniform(0.1, 0.9, D).astype(np.float32)
    p["w0"] = rng.uniform(-3.0, 0.5, D).astype(np.float32)
    return p


def _both(p):
    return (jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


@pytest.mark.parametrize("t,chunk", [(16, 8), (32, 32), (24, 8)])
def test_wkv_chunked_matches_repro(t, chunk):
    rng = np.random.default_rng(t)
    r, k, v = (rng.standard_normal((2, t, H, DH)).astype(np.float32)
               for _ in range(3))
    log_decay = -np.exp(rng.uniform(-4, 1, (2, t, H, DH))).astype(
        np.float32)
    u = rng.standard_normal((H, DH)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((2, H, DH, DH)).astype(np.float32)
    jy, js = j_ssm._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v,
                                                            log_decay, u,
                                                            s0)), chunk)
    ty, ts = t_ssm._wkv_chunked(*(torch.from_numpy(a) for a in (
        r, k, v, log_decay, u, s0)), chunk)
    assert ty.dtype == ts.dtype == torch.float32
    assert _err(ty, jy) <= 1e-3 * _scale(jy)
    assert _err(ts, js) <= 1e-3 * _scale(js)


# chunk 8: T 16 takes the chunked form (two chunks), T 20 and T 1 (decode)
# the per-token recurrence, as in repro
@pytest.mark.parametrize("t", [16, 20, 1])
@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_matches_repro(t, carried):
    p = _params(1)
    jp, tp = _both(p)
    rng = np.random.default_rng(t + 10 * carried)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    prev = (rng.standard_normal((2, 1, D)) if carried
            else np.zeros((2, 1, D))).astype(np.float32)
    s0 = (rng.standard_normal((2, H, DH, DH)) * carried).astype(np.float32)
    with perf.flags(rwkv_chunk=8):
        jy, jlast, js = j_ssm.rwkv6_time_mix(
            jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(prev),
            jnp.asarray(s0), n_heads=H)
    with t_perf.flags(rwkv_chunk=8):
        ty, tlast, ts = t_ssm.rwkv6_time_mix(
            tp, torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(prev) if carried else None,
            torch.from_numpy(s0), n_heads=H)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    assert _err(ty, jy) <= 2e-2 * _scale(jy)
    assert _err(ts, js) <= 2e-2 * _scale(js)
    assert _err(tlast, jlast) == 0.0


@pytest.mark.parametrize("t", [16, 1])
def test_channel_mix_matches_repro(t):
    p = _params(2)
    jp, tp = _both(p)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    prev = rng.standard_normal((2, 1, D)).astype(np.float32)
    jy, jlast = j_ssm.rwkv6_channel_mix(jp, jnp.asarray(x, jnp.bfloat16),
                                        jnp.asarray(prev))
    ty, tlast = t_ssm.rwkv6_channel_mix(
        tp, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(prev))
    assert ty.dtype == torch.bfloat16
    assert _err(ty, jy) <= 2e-2 * _scale(jy)
    assert _err(tlast, jlast) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_shift_is_the_conv1d_kernel_at_fl_2(dtype, monkeypatch):
    """The lerp runs through ``kernels.conv1d`` (its plain version on the
    CPU) with taps (1 - mu, mu) and matches repro's lerp; a carried prev
    is the row before the first."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    prev = rng.standard_normal((2, 1, D)).astype(np.float32)
    mu = rng.uniform(0.1, 0.9, D).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    calls, real = [], t_conv1d.conv1d_causal_plain
    monkeypatch.setattr(t_conv1d, "conv1d_causal_plain", lambda a, w: (
        calls.append(tuple(w.shape)) or real(a, w)))
    for pv in (None, prev):
        want = j_ssm._token_shift(jnp.asarray(x, jd),
                                  jnp.zeros((2, 1, D)) if pv is None
                                  else jnp.asarray(pv), jnp.asarray(mu))
        calls.clear()
        got = t_ssm._token_shift(torch.from_numpy(x).to(dtype),
                                 None if pv is None else torch.from_numpy(pv),
                                 torch.from_numpy(mu))
        assert calls == [(2, D)]
        assert got.dtype == dtype and tuple(got.shape) == (2, 9, D)
        tol = 1e-6 if dtype == torch.float32 else 2e-2
        assert _err(got, want) <= tol * _scale(want)
