"""Port parity: the LM layers and whole prefill/decode against ``repro``.

Both packages get the same numpy inputs and weights (``repro``'s
``init_params`` pytree crosses through ``lm_params_from_numpy``); the port
runs its plain engine on the CPU.  Tolerances, stated per check:

* rope / M-RoPE / rmsnorm in fp32: 1e-5 (one fp32 rounding of cos/sin);
  in bf16: one bf16 step at the output's scale, 2^-7·max(1, max|ref|).
* ffn and Mamba2 in bf16: 2e-2·max(1, max|ref|): both round the dense
  outputs to bf16, in different summation orders, so single values may land
  on the neighbouring bf16 value and carry into the next layer.
* whole prefill/decode logits against ``repro`` (bf16 activations through
  every layer): 2e-2·max(1, max|ref|).  The smoke logits reach about 0.5
  and differ by a few bf16 steps (about 6e-3): the port's attention runs the
  flash kernel's plain version where ``repro`` runs its dense masked softmax
  (T <= 1024), which rounds p to bf16 before normalising, not after.
* the port's prefill(T+1) against its prefill(T) + decode: ``repro``'s own
  rule (``tests/test_models.py:73-74``), 5e-2 for recurrent archs; for
  attention archs, where ``repro`` demands equality, one bf16 step at the
  largest logit, 2^-7·max|ref| (the same math, but the CPU matmuls may block
  a (T+1)-row and a 1-row product differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models import ssm as j_ssm
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import lm_params_from_numpy, params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this file's torch ops on one thread: under xdist the other
    workers' timing-based benchmark tests share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _err(got, want) -> float:
    return float(np.max(np.abs(_f32(got) - _f32(want))))


def _scale(want) -> float:
    return max(1.0, float(np.max(np.abs(_f32(want)))))


# ------------------------------- configs -------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_repros(arch):
    for smoke in (False, True):
        assert get_config(arch, smoke).__dict__ == \
            j_get_config(arch, smoke).__dict__


# -------------------------------- layers -------------------------------------
@pytest.mark.parametrize("dtype", list(DT))
def test_rope_and_mrope_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 2000, (3, 2, 7)).astype(np.int32)
    jd, td = DT[dtype]
    want = j_attn.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 1e4)
    got = t_attn.apply_rope(_t(x, td), _t(pos), 1e4)
    want3 = j_attn.apply_mrope(jnp.asarray(x, jd), jnp.asarray(pos3), 1e6,
                               (2, 3, 3))
    got3 = t_attn.apply_mrope(_t(x, td), _t(pos3), 1e6, (2, 3, 3))
    for g, w in ((got, want), (got3, want3)):
        assert g.dtype == td
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * _scale(w)
        assert _err(g, w) <= tol


@pytest.mark.parametrize("dtype", list(DT))
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    jd, td = DT[dtype]
    want = j_layers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x, jd))
    got = t_layers.rmsnorm({"g": _t(g)}, _t(x, td))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * _scale(want)
    assert _err(got, want) <= tol


@pytest.mark.parametrize("gated,activation", [(True, "silu"),
                                              (True, "gelu"), (False, "gelu")])
def test_ffn_matches(gated, activation):
    p = _np(j_layers.ffn_init(jax.random.PRNGKey(2), 32, 64, gated=gated))
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    want = j_layers.ffn(jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x, jnp.bfloat16), activation=activation)
    got = t_layers.ffn(params_from_numpy(p, device="cpu"),
                       _t(x, torch.bfloat16), activation=activation)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= 2e-2 * _scale(want)


def test_compute_copies_change_nothing():
    p = _np(j_layers.ffn_init(jax.random.PRNGKey(3), 16, 32))
    x = _t(np.random.default_rng(3).standard_normal((3, 16)), torch.bfloat16)
    plain = params_from_numpy(p, device="cpu")
    held = t_layers.with_compute_copies(plain)
    assert held["wi"]["wc"].dtype == torch.bfloat16
    assert torch.equal(t_layers.ffn(plain, x), t_layers.ffn(held, x))


# -------------------------------- Mamba2 -------------------------------------
def _mamba(d_model=32, d_state=8, head_dim=16):
    p = _np(j_ssm.mamba2_init(jax.random.PRNGKey(4), d_model, d_state,
                              head_dim=head_dim))
    p["A_log"] = np.random.default_rng(5).uniform(-1, 1, p["A_log"].shape
                                                  ).astype(np.float32)
    p["dt_bias"] = np.random.default_rng(6).uniform(
        -3, 0, p["dt_bias"].shape).astype(np.float32)
    return p, dict(d_state=d_state, head_dim=head_dim)


def test_mamba2_prefill_and_states_match():
    p, kw = _mamba()
    x = np.random.default_rng(7).standard_normal((2, 32, 32)).astype(
        np.float32)
    want, (js, jc) = j_ssm.mamba2(jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x, jnp.bfloat16), chunk=8,
                                  return_state=True, **kw)
    got, (ts, tc) = t_ssm.mamba2(params_from_numpy(p, device="cpu"),
                                 _t(x, torch.bfloat16), chunk=8,
                                 return_state=True, **kw)
    assert got.dtype == torch.bfloat16 and ts.dtype == tc.dtype == \
        torch.float32
    assert _err(got, want) <= 2e-2 * _scale(want)
    assert _err(ts, js) <= 2e-2 * _scale(js)
    assert _err(tc, jc) <= 2e-2 * _scale(jc)   # the pre-conv inputs, fp32


def test_mamba2_decode_matches():
    p, kw = _mamba()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    state = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 64 + 16)).astype(np.float32)
    want = j_ssm.mamba2_decode(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(state), jnp.asarray(conv), **kw)
    got = t_ssm.mamba2_decode(params_from_numpy(p, device="cpu"),
                              _t(x, torch.bfloat16), _t(state), _t(conv),
                              **kw)
    for g, w in zip(got, want):
        assert _err(g, w) <= 2e-2 * _scale(w)


# ------------------------- whole prefill / decode ----------------------------
LM_ARCHS = ["zamba2-2.7b", "smollm-135m"]
B, T = 2, 16


def _setup(arch):
    jcfg = j_get_config(arch, smoke=True)
    jp = j_lm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(_np(jp), device="cpu")
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (B, T + 1)
                                              ).astype(np.int32)
    return jcfg, get_config(arch, smoke=True), jp, tp, toks


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_repro(arch):
    jcfg, cfg, jp, tp, toks = _setup(arch)
    jl, jc = j_lm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :T])},
                          max_seq=T + 4)
    tl, tc = t_lm.prefill(cfg, tp, {"tokens": _t(toks[:, :T]).long()},
                          max_seq=T + 4)
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.bfloat16
    assert _err(tl, jl) <= 2e-2 * _scale(jl)
    jd, _ = j_lm.decode_step(jcfg, jp, {
        "token": jnp.asarray(toks[:, T:]),
        "pos": jnp.full((B,), T, jnp.int32)}, jc)
    td, tc2 = t_lm.decode_step(cfg, tp, {
        "token": _t(toks[:, T:]).long(),
        "pos": torch.full((B,), T, dtype=torch.int32)}, tc)
    assert tc2 is tc                      # the cache is updated in place
    assert _err(td, jd) <= 2e-2 * _scale(jd)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_then_decode_equals_longer_prefill(arch):
    """The port's own prefill(T+1) against prefill(T) + one decode step, as
    ``tests/test_models.py`` checks ``repro`` (tolerances: module docstring;
    the Mamba2 state is summed in another order by the chunked and the
    recurrent form)."""
    _, cfg, _, tp, toks = _setup(arch)
    full, _ = t_lm.prefill(cfg, tp, {"tokens": _t(toks).long()},
                           max_seq=T + 4)
    _, cache = t_lm.prefill(cfg, tp, {"tokens": _t(toks[:, :T]).long()},
                            max_seq=T + 4)
    dec, _ = t_lm.decode_step(cfg, tp, {
        "token": _t(toks[:, T:]).long(),
        "pos": torch.full((B,), T, dtype=torch.int32)}, cache)
    tol = (2.0 ** -7 * float(np.max(np.abs(_f32(full))))
           if cfg.block_type == "attn" else 5e-2 * _scale(full))
    assert _err(dec, full) <= tol


def test_kv_cache_holds_the_prefill_keys():
    jcfg, cfg, jp, tp, toks = _setup("smollm-135m")
    _, jc = j_lm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :T])},
                         max_seq=T + 4)
    _, tc = t_lm.prefill(cfg, tp, {"tokens": _t(toks[:, :T]).long()},
                         max_seq=T + 4)
    for n in ("k", "v"):
        got, want = tc["p0"][n], jc["p0"][n]
        assert tuple(got.shape) == want.shape
        assert _err(got[:, :, T:], want[:, :, T:]) == 0.0   # still zero
        assert _err(got, want) <= 2e-2 * _scale(want)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-1.6b",
                                  "llama4-maverick-400b-a17b"])
def test_unported_blocks_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_lm.init_params(get_config(arch, smoke=True), device="cpu")


def test_windowed_decode_raises():
    cfg = get_config("gemma2-9b", smoke=True)
    params = t_lm.init_params(cfg, device="cpu")
    _, cache = t_lm.prefill(cfg, params, {"tokens": torch.zeros(
        (1, 4), dtype=torch.long)}, max_seq=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_lm.decode_step(cfg, params, {
            "token": torch.zeros((1, 1), dtype=torch.long),
            "pos": torch.full((1,), 4, dtype=torch.int32)}, cache)


def test_serve_runs_on_the_cpu(capsys):
    serve.main(["--arch", "zamba2-2.7b", "--smoke", "--prompt-len", "8",
                "--gen", "4", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 8 tokens x2" in out and "decoded 4 tokens/seq" in out
    assert "sample:" in out


def test_generate_feeds_back_the_argmax():
    cfg, params = serve.load_model("smollm-135m", smoke=True, device="cpu")
    prompts = serve.make_prompts(cfg, 2, 8, device="cpu")
    out = serve.generate(cfg, params, prompts, 4)
    logits, cache = t_lm.prefill(cfg, params, prompts, max_seq=12)
    tokens = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
    for i in range(3):
        logits, cache = t_lm.decode_step(cfg, params, {
            "token": tokens[-1],
            "pos": torch.full((2,), 8 + i, dtype=torch.int32)}, cache)
        tokens.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
    assert torch.equal(out["tokens"], torch.cat(tokens, dim=1))


def test_fp32_activations_are_passed_explicitly():
    # the fp32 plain engine is the chip check's reference for the bf16 ones
    cfg, params = serve.load_model("zamba2-2.7b", smoke=True, device="cpu")
    prompts = serve.make_prompts(cfg, 2, 64, device="cpu")
    step = {"token": torch.ones((2, 1), dtype=torch.long),
            "pos": torch.full((2,), 64, dtype=torch.int32)}
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        logits, cache = t_lm.prefill(cfg, params, prompts, max_seq=65,
                                     dtype=dtype)
        assert cache["shared"]["k"].dtype == dtype
        step_logits, _ = t_lm.decode_step(cfg, params, step, cache,
                                          dtype=dtype)
        assert logits.dtype == step_logits.dtype == dtype
        runs[dtype] = (logits.float(), step_logits.float())
    assert t_lm.COMPUTE_DTYPE == torch.bfloat16
    for a, b in zip(runs[torch.bfloat16], runs[torch.float32]):
        # bf16 keeps 8 significant bits: a few steps at the largest logit
        assert (a - b).abs().max() <= 5e-2 * max(1.0, b.abs().max().item())
