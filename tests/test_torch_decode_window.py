"""Port parity: windowed, soft-capped and rolling-cache decode
(``repro_torch.models.attention.attention_decode``, the decode kernel's
plain version on the CPU) against ``repro.models.attention.attention_decode``
on the same numpy weights, caches and positions.

Cases: a linear cache with a window, with a soft-cap, with both; a ring of
W slots (``rolling_window``) at ``pos < W - 1``, ``pos = W - 1``, ``pos >=
W`` and several times round, a different ``pos`` per row, with and
without a soft-cap.  Both the output and the updated caches are compared.

Tolerances: fp32 1e-4·max(1, max|ref|) (the same fp32 math; the port sums
exp(s - m) and divides once, ``repro`` normalises the softmax first); bf16
2e-2·max(1, max|ref|) (the port rounds the unnormalised p to bf16, ``repro``
the normalised weights, as in ``tests/test_torch_lm.py``).  The caches:
every slot but the written one unchanged, exactly; the written k and v rows
(a projection and RoPE) within the rope tolerance of
``tests/test_torch_lm.py``, fp32 1e-5 and bf16 one step, 2^-7·max(1,
max|ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro_torch.kernels import decode_attention as t_decode
from repro_torch.models import attention as t_attn
from repro_torch.models.convert import params_from_numpy

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D, H, KH, DH = 32, 4, 2, 16


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _run(dtype, s, pos, *, window=0, cap=0.0, rolling=0, seed=0):
    jd, td = DT[dtype]
    p = jax.tree_util.tree_map(np.asarray, j_attn.attention_init(
        jax.random.PRNGKey(seed), D, H, KH, DH))
    rng = np.random.default_rng(seed)
    b = len(pos)
    x = rng.standard_normal((b, 1, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, s, KH, DH)).astype(np.float32)
              for _ in range(2))
    kw = dict(n_heads=H, n_kv_heads=KH, d_head=DH, window=window,
              attn_softcap=cap, rolling_window=rolling)
    pos = np.asarray(pos, np.int32)
    want = j_attn.attention_decode(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x, jd),
        jnp.asarray(ck, jd), jnp.asarray(cv, jd), jnp.asarray(pos), **kw)
    tk, tv = (torch.from_numpy(a).to(td) for a in (ck, cv))
    got = t_attn.attention_decode(
        params_from_numpy(p, device="cpu"), torch.from_numpy(x).to(td),
        tk, tv, torch.from_numpy(pos), **kw)
    assert got[1] is tk and got[2] is tv          # updated in place
    written = np.zeros((b, s), bool)
    written[np.arange(b), pos % rolling if rolling else pos] = True
    return want, got, written


def _check(want, got, written, dtype):
    (jo, jk, jv), (to, tk, tv) = want, got
    assert to.dtype == DT[dtype][1] and tuple(to.shape) == jo.shape
    scale = max(1.0, float(np.max(np.abs(_f32(jo)))))
    tol = (1e-4 if dtype == "float32" else 2e-2) * scale
    assert float(np.max(np.abs(_f32(to) - _f32(jo)))) <= tol
    for t_c, j_c in ((tk, jk), (tv, jv)):
        t_c, j_c = _f32(t_c), _f32(j_c)
        assert np.array_equal(t_c[~written], j_c[~written])
        row_tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * max(
            1.0, float(np.max(np.abs(j_c[written]))))
        assert float(np.max(np.abs(t_c[written] - j_c[written]))) <= row_tol


LINEAR = [  # (S, pos per row, window, soft-cap)
    (40, (39, 5, 20), 8, 0.0),      # window past the start, and not yet
    (40, (30, 7), 0, 5.0),          # soft-cap alone
    (70, (69, 64, 3), 16, 5.0),     # both; a window inside one 64-row tile
    (130, (129, 100), 65, 2.0),     # a window across a tile boundary
]


@pytest.mark.parametrize("s,pos,window,cap", LINEAR)
@pytest.mark.parametrize("dtype", list(DT))
def test_linear_cache_window_and_softcap_match_repro(s, pos, window, cap,
                                                     dtype):
    _check(*_run(dtype, s, pos, window=window, cap=cap), dtype)


RING = [  # (W, pos per row, soft-cap): pos < W - 1, = W - 1, >= W, wrapped
    (16, (3, 15), 0.0),
    (16, (16, 40, 9), 0.0),
    (16, (15, 31, 100), 50.0),
    (20, (0, 19, 20, 57), 3.0),
]


@pytest.mark.parametrize("w,pos,cap", RING)
@pytest.mark.parametrize("dtype", list(DT))
def test_rolling_cache_matches_repro(w, pos, cap, dtype):
    # repro's ring layers pass their window too; the ring ignores it
    _check(*_run(dtype, w, pos, window=w, cap=cap, rolling=w), dtype)


def test_ring_is_the_causal_mask_at_min_pos_w_minus_1():
    """The mapping ``attention_decode`` relies on: over a ring of W slots,
    repro's visible slots (``kpos = pos - ((pos - s) mod W) >= 0``) are
    exactly ``s <= min(pos, W - 1)``."""
    for w in (1, 4, 16):
        s = np.arange(w)
        for pos in range(0, 5 * w):
            kpos = pos - np.mod(pos - s, w)
            assert np.array_equal(kpos >= 0, s <= min(pos, w - 1))


def test_decode_wrapper_takes_window_and_softcap_on_the_cpu():
    """The wrapper's CPU path is its plain version with the same
    arguments, and counts no launch."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g)
    ck, cv = (torch.randn(2, 50, 2, 16, generator=g) for _ in range(2))
    pos = torch.tensor([49, 20], dtype=torch.int32)
    before = t_decode.decode_attention.launches
    got = t_decode.decode_attention(q, ck, cv, pos, window=10, softcap=3.0)
    want = t_decode.decode_attention_plain(q, ck, cv, pos, window=10,
                                           softcap=3.0)
    assert torch.equal(got, want)
    assert t_decode.decode_attention.launches == before
    # the window and the cap change the answer
    assert not torch.allclose(got, t_decode.decode_attention(q, ck, cv, pos))
