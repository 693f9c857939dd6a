"""Head dims the attention kernels are not built at (``HEAD_DIMS``): the
wrappers zero-pad q, k and v to the next built width, launch with the
unpadded dh's scale and slice the output back
(``kernels.flash_attention.with_padded_head_dim``); above 256 they launch
the wide kernels unpadded, up to ``WIDE_MAX_HEAD_DIM``.  On the CPU the helper
is driven through the kernels' plain versions, which take any head dim:
padded and sliced must equal unpadded, and the scale of the padded width
must not.  smollm-360m's smoke config (dh 20) is the case the configs
have; ``chip_smoke.py`` serves it on the card.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

# fp32: the padded columns add exact zeros to every product, so the two
# agree to rounding of the einsum's blocking at most
TOL = {torch.float32: 1e-6, torch.bfloat16: 0.0}


def _qkv(b, t, h, kh, dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g).to(dtype)
    return rn(b, t, h, dh), rn(b, t, kh, dh), rn(b, t, kh, dh)


@pytest.mark.parametrize("dh,wide", [(20, 64), (16, 16), (17, 64), (64, 64),
                                     (65, 80), (80, 80), (100, 128),
                                     (129, 256), (256, 256),
                                     # the wide kernels: dh itself
                                     (257, 257), (272, 272), (384, 384),
                                     (1024, 1024), (2048, 2048)])
def test_padded_head_dim(dh, wide):
    assert fa.padded_head_dim(dh) == wide


def test_padded_head_dim_refuses_wider_than_the_wide_kernels():
    assert fa.WIDE_MAX_HEAD_DIM == 2048
    with pytest.raises(ValueError, match="above the widest the kernels "
                                         "take, 2048"):
        fa.padded_head_dim(2049)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap,q_offset",
                         [(0, 0.0, 0), (16, 0.0, 0), (0, 30.0, 0),
                          (24, 20.0, 8)])
def test_flash_padding_keeps_the_unpadded_function(dtype, window, softcap,
                                                   q_offset):
    q, k, v = _qkv(2, 40, 3, 1, 20, dtype)
    k, v = (torch.cat([t, t[:, :q_offset]], dim=1) for t in (k, v))
    kw = dict(window=window, softcap=softcap, q_offset=q_offset)
    want = fa.flash_attention_plain(q, k, v, **kw)
    got = fa.with_padded_head_dim(fa.flash_attention_plain, q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_flash_padding_needs_the_unpadded_scale():
    """The trap: scaling by the padded width's dh moves every score."""
    q, k, v = _qkv(1, 32, 3, 1, 20, torch.float32)
    want = fa.flash_attention_plain(q, k, v)
    pad = lambda t: torch.nn.functional.pad(t, (0, 44))
    wrong = fa.flash_attention_plain(pad(q), pad(k), pad(v))[..., :20]
    assert (wrong - want).abs().max().item() > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap,k_offset",
                         [(0, 0.0, 0), (32, 0.0, 0), (0, 50.0, 0),
                          (0, 0.0, 16)])
def test_decode_padding_keeps_output_and_log_sum_exp(dtype, window, softcap,
                                                     k_offset):
    g = torch.Generator().manual_seed(1)
    rn = lambda *s: torch.randn(s, generator=g).to(dtype)
    q, ck, cv = rn(2, 3, 20), rn(2, 80, 1, 20), rn(2, 80, 1, 20)
    pos = torch.tensor([64, 79 + k_offset], dtype=torch.int32)
    kw = dict(window=window, softcap=softcap, k_offset=k_offset,
              return_lse=True)
    want, want_lse = da.decode_attention_plain(q, ck, cv, pos, **kw)
    got, lse = fa.with_padded_head_dim(da.decode_attention_plain, q, ck, cv,
                                       pos, **kw)
    assert got.shape == want.shape and got.is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.allclose(lse, want_lse, atol=1e-6, rtol=0)


def test_flash_launch_pads_to_a_built_width(monkeypatch):
    """``_launch`` hands the built-width launch padded operands and the
    unpadded scale, and returns dh columns."""
    seen = {}

    def launch_built(q, k, v, *, window, softcap, q_offset, scale):
        seen.update(dh=q.shape[-1], scale=scale)
        return fa.flash_attention_plain(q, k, v, window=window,
                                        softcap=softcap, q_offset=q_offset,
                                        scale=scale)

    monkeypatch.setattr(fa, "_launch_built", launch_built)
    q, k, v = _qkv(2, 33, 3, 1, 20, torch.float32)
    out = fa._launch(q, k, v, 0, 0.0)
    assert seen == {"dh": 64, "scale": 20 ** -0.5}
    assert torch.allclose(out, fa.flash_attention_plain(q, k, v), atol=1e-6,
                          rtol=0)


def test_decode_launch_pads_to_a_built_width():
    seen = {}

    def launch(q, ck, cv, pos, *, window, softcap, k_offset, return_lse,
               scale):
        seen.update(dh=q.shape[-1], scale=scale)
        return da.decode_attention_plain(q, ck, cv, pos, window=window,
                                         softcap=softcap, k_offset=k_offset,
                                         return_lse=return_lse, scale=scale)

    g = torch.Generator().manual_seed(2)
    q, ck, cv = (torch.randn(s, generator=g)
                 for s in ((2, 3, 20), (2, 72, 1, 20), (2, 72, 1, 20)))
    pos = torch.tensor([64, 71], dtype=torch.int32)
    out = fa.with_padded_head_dim(launch, q, ck, cv, pos, window=0,
                                  softcap=0.0, k_offset=0, return_lse=False)
    assert seen == {"dh": 64, "scale": 20 ** -0.5}
    assert torch.allclose(out, da.decode_attention_plain(q, ck, cv, pos),
                          atol=1e-6, rtol=0)


@pytest.mark.parametrize("dh", [257, 272, 384, 1024, 2048])
def test_flash_launch_takes_wide_head_dims_unpadded(monkeypatch, dh):
    """Above 256 ``_launch`` hands the launch q, k and v as they are, at
    dh's own scale."""
    seen = {}

    def launch_built(q, k, v, *, window, softcap, q_offset, scale):
        seen.update(dh=q.shape[-1], scale=scale)
        return fa.flash_attention_plain(q, k, v, window=window,
                                        softcap=softcap, q_offset=q_offset,
                                        scale=scale)

    monkeypatch.setattr(fa, "_launch_built", launch_built)
    q, k, v = _qkv(1, 9, 2, 1, dh, torch.float32)
    out = fa._launch(q, k, v, 0, 0.0)
    assert seen == {"dh": dh, "scale": dh ** -0.5}
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("dh", [257, 272, 512, 2048])
def test_decode_launch_takes_wide_head_dims_unpadded(dh):
    seen = {}

    def launch(q, ck, cv, pos, *, window, softcap, k_offset, return_lse,
               scale):
        seen.update(dh=q.shape[-1], scale=scale)
        return da.decode_attention_plain(q, ck, cv, pos, window=window,
                                         softcap=softcap, k_offset=k_offset,
                                         return_lse=return_lse, scale=scale)

    g = torch.Generator().manual_seed(3)
    q, ck, cv = (torch.randn(s, generator=g)
                 for s in ((2, 4, dh), (2, 40, 2, dh), (2, 40, 2, dh)))
    pos = torch.tensor([39, 7], dtype=torch.int32)
    out, lse = fa.with_padded_head_dim(launch, q, ck, cv, pos, window=8,
                                       softcap=30.0, k_offset=0,
                                       return_lse=True)
    assert seen == {"dh": dh, "scale": dh ** -0.5}
    want, want_lse = da.decode_attention_plain(q, ck, cv, pos, window=8,
                                               softcap=30.0, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


def test_smollm_360m_smoke_config_has_an_unbuilt_head_dim():
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m", smoke=True)
    dh = cfg.d_model // cfg.n_heads
    assert dh == 20 and dh not in fa.HEAD_DIMS
    assert fa.padded_head_dim(dh) in fa.HEAD_DIMS


def test_wide_launches_refuse_head_dims_past_2048(monkeypatch):
    """Both launches refuse dh 2049 with ``padded_head_dim``'s message
    before anything reaches the kernel."""
    monkeypatch.setattr(fa, "_launch_built", lambda *a, **k: pytest.fail(
        "the flash kernel was reached"))
    msg = "above the widest the kernels take, 2048"
    q, k, v = _qkv(1, 3, 2, 1, 2049, torch.float32)
    with pytest.raises(ValueError, match=msg):
        fa._launch(q, k, v, 0, 0.0)
    with pytest.raises(ValueError, match=msg):
        fa.with_padded_head_dim(
            lambda *a, **kw: pytest.fail("the decode kernel was reached"),
            q[:, 0], k, v, torch.zeros(1, dtype=torch.int32), window=0,
            softcap=0.0, k_offset=0, return_lse=False)


# The wide decode kernel's grid is (splits, KH, B): one block per (split,
# kv head, batch) scores all G heads of the group, and the occupancy query
# reports blocks per SM undivided by G. (b, s, h, kh, dh, slots) -> the
# splits and tiles a split that fill one wave.
WIDE_PLANS = [((4, 2048, 8, 4, 512, 132), (8, 4)),
              ((1, 2048, 8, 4, 512, 132), (32, 1)),
              ((2, 1000, 6, 3, 1024, 132), (16, 1)),
              ((4, 2048, 8, 4, 2048, 264), (16, 2)),
              ((3, 300, 8, 2, 301, 132), (5, 1)),
              ((64, 4096, 32, 4, 512, 132), (1, 64))]


@pytest.mark.parametrize("shape,want", WIDE_PLANS)
def test_decode_launch_plan_fills_one_wave_of_the_wide_grid(shape, want):
    b, s, h, kh, dh, slots = shape
    plan = da.launch_plan(b, s, h, kh, dh, slots)
    assert (plan.splits, plan.split_tiles) == want
    tiles = -(-s // da.CHUNK)
    # whole tiles, none empty, every row covered
    assert plan.splits * plan.split_tiles >= tiles
    assert (plan.splits - 1) * plan.split_tiles < tiles
    # B x KH x splits blocks, one wave of the card's slots (at least one
    # split per (b, kh)), and as many splits as that wave allows
    assert b * kh * plan.splits <= max(slots, b * kh)
    assert plan.splits == min(tiles, max(1, slots // (b * kh))) or \
        -(-tiles // (plan.split_tiles - 1)) > max(1, slots // (b * kh))
    # a max, a sum and dh outputs per (b, kh, split, head of the group)
    assert plan.ws_floats == b * kh * plan.splits * (h // kh) * (2 + dh)
    assert plan.tickets == b * kh

