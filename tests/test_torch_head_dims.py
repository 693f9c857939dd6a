"""Head dims the attention kernels are not built at (``HEAD_DIMS``): the
wrappers zero-pad q, k and v to the next built width, launch with the
unpadded dh's scale and slice the output back
(``kernels.flash_attention.with_padded_head_dim``).  On the CPU the helper
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
                                     (129, 256), (256, 256)])
def test_padded_head_dim(dh, wide):
    assert fa.padded_head_dim(dh) == wide


def test_padded_head_dim_refuses_wider_than_built():
    with pytest.raises(ValueError, match="above the widest"):
        fa.padded_head_dim(257)


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


def test_smollm_360m_smoke_config_has_an_unbuilt_head_dim():
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m", smoke=True)
    dh = cfg.d_model // cfg.n_heads
    assert dh == 20 and dh not in fa.HEAD_DIMS
    assert fa.padded_head_dim(dh) in fa.HEAD_DIMS
