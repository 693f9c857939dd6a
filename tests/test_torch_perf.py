"""The port's §Perf flags (``repro_torch.perf``) against ``repro.perf``, and
every flag's off path against ``repro``'s under the same flags.

* The flags: ``PerfConfig``'s fields and defaults, ``_ON``, ``_OFF``,
  ``REPRO_PERF=off`` (in a subprocess), ``flags``/``baseline`` restoring
  the state (also when the body raises); the dry run's ``set_perf`` and its
  ``--perf`` default (``off`` in both packages).
* ``steps.cache_specs``' shapes and dtypes against ``repro``'s for all ten
  archs at the smoke and full decode shapes, under the default flags, the
  baseline and ``windowed_local_cache`` off (meta tensors against
  ``jax.eval_shape``).
* Each flag flipped from its default, and ``baseline()``, on the archs it
  touches: a prefill of T = 24 (past the smoke window of 16) and decode
  steps from position 24, the logits and every cache entry against
  ``repro``'s under the same flags.  Tolerances (``tests/test_torch_lm.py``'s):
  fp32 activations on both sides, 4 decode steps, within 1e-4 x max(1,
  max|ref|) (fp32 sums in other orders); bf16 (the flags that change
  bf16 numerics, and the baseline on the archs they touch), the prefill
  and one decode step, as ``test_torch_lm.py`` checks bf16, within 2e-2 x
  max(1, max|ref|).  (bf16 k/v written each step differ between the packages in
  the last bit and compound: mixtral's logits drift to 2.2e-2 x max|ref|
  by the third step with the default flags too, and a near-tie in top-k
  routing moves a token's logits by O(1).)  Beside them, with bf16
  activations: the attention kernels get fp32 copies exactly when
  ``bf16_attn_io`` is off, and ``bf16_moe_dispatch`` off changes the
  memory of the combine tensor, not one bit of the logits.
* On a (2, 2) ('data', 'model') mesh of four ``gloo`` processes (as
  ``tests/test_torch_distribution.py``), fp32, 1e-4 x max(1, max|ref|):
  mixtral's sharded prefill and decode with ``grouped_moe_dispatch`` off
  against the unsharded port and ``repro``'s flat routing, and its sharded
  train loss against the unsharded one (the balance loss over the gathered
  sequence); with ``tp_serving_params`` on, the sharded decode against the
  unsharded one, its params placed without the 'data' axis.  The decode
  param specs under ``tp_serving_params`` against ``repro``'s for all ten
  archs on both production meshes need no process group.
* Training: rwkv6's fp32 loss and every gradient leaf with
  ``rwkv_chunked`` off (the per-token WKV) against
  ``jax.value_and_grad``, 1e-4 x max(1, max|ref|).

An autouse fixture holds both packages' flags at their state when this
file was imported after every test.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from repro import perf as j_perf
from repro.configs import get_config as j_get_config
from repro.launch import steps as j_steps
from repro.models import lm as j_lm
from repro_torch import perf
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.launch import dryrun, steps
from repro_torch.models import lm as t_lm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.pytree import flatten

ROOT = Path(__file__).resolve().parent.parent
START = (j_perf.get(), perf.get())
MODE_FLAGS = ("bf16_attn_io", "rwkv_chunked", "bf16_moe_dispatch",
              "windowed_local_cache")


@pytest.fixture(autouse=True)
def _flags_restored():
    yield
    assert (j_perf.get(), perf.get()) == START


def _repro_dryrun():
    """``repro.launch.dryrun``; it sets XLA_FLAGS to 512 host devices at
    import, which must not reach this process's JAX."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as j_dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return j_dryrun


# ------------------------------------------------------------- the flags ----
def test_perf_config_matches_repro():
    fields = [(f.name, f.default) for f in dataclasses.fields(perf.PerfConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(j_perf.PerfConfig)]
    for name in ("_ON", "_OFF"):
        assert dataclasses.asdict(getattr(perf, name)) == \
            dataclasses.asdict(getattr(j_perf, name))


@pytest.mark.parametrize("env", ["off", "on", None])
def test_repro_perf_env_gives_the_same_state(env):
    code = ("import dataclasses, json; from repro import perf as j; "
            "from repro_torch import perf as t; print(json.dumps("
            "[dataclasses.asdict(m.get()) for m in (j, t)]))")
    e = {k: v for k, v in os.environ.items() if k != "REPRO_PERF"}
    e["PYTHONPATH"] = str(ROOT / "src")
    if env is not None:
        e["REPRO_PERF"] = env
    out = subprocess.run([sys.executable, "-c", code], env=e, check=True,
                         capture_output=True, text=True).stdout
    want = dataclasses.asdict(perf._OFF if env == "off" else perf._ON)
    assert json.loads(out) == [want, want]


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_flags_and_baseline_restore_the_state(pkg):
    m = j_perf if pkg == "repro" else perf
    before = m.get()
    with m.flags(rwkv_chunk=64, tp_serving_params=True) as cur:
        assert cur == m.get()
        assert (cur.rwkv_chunk, cur.tp_serving_params) == (64, True)
        with m.baseline() as base:
            assert base == m._OFF == m.get()
        assert m.get() == cur
    assert m.get() == before
    for ctx in (m.flags(bf16_attn_io=False), m.baseline()):
        with pytest.raises(KeyError):
            with ctx:
                assert not m.get().bf16_attn_io
                raise KeyError("body")
        assert m.get() == before


@pytest.mark.parametrize("start", [{}, {"tp_serving_params": True,
                                        "rwkv_chunk": 64,
                                        "grouped_moe_dispatch": False}])
@pytest.mark.parametrize("mode", ["on", "off", "bf16_attn_io,rwkv_chunked",
                                  "windowed_local_cache"])
def test_dryrun_set_perf_matches_repro(mode, start):
    j_dryrun = _repro_dryrun()
    with j_perf.flags(**start), perf.flags(**start):
        j_dryrun.set_perf(mode)
        dryrun.set_perf(mode)
        got, want = dataclasses.asdict(perf.get()), \
            dataclasses.asdict(j_perf.get())
    assert got == want
    named = MODE_FLAGS if mode in ("on", "off") else mode.split(",")
    for k in MODE_FLAGS:
        assert got[k] == (mode != "off" and k in named)


def test_dryrun_perf_defaults_to_off(monkeypatch):
    """The dry run traces the paper-faithful baseline unless asked, in both
    packages (the port's used to default to, and accept only, 'on')."""
    class Stop(Exception):
        pass

    seen = []

    def record(mode):
        seen.append(mode)
        raise Stop

    j_dryrun = _repro_dryrun()
    monkeypatch.setattr(j_dryrun, "set_perf", record)
    monkeypatch.setattr(sys, "argv", ["dryrun"])
    with pytest.raises(Stop):
        j_dryrun.main()
    monkeypatch.setattr(dryrun, "set_perf", record)
    with pytest.raises(Stop):
        dryrun.main([])
    assert seen == ["off", "off"]


def test_dryrun_traces_the_flags_it_is_given(tmp_path):
    """smollm-135m's smoke train cell traced under --perf off and on: the
    records name the flags, and the programs differ (under off attention
    takes fp32 copies of q, k and v, and its plain version rounds no p to
    bf16)."""
    recs = {}
    for mode in ("off", "on"):
        recs[mode], = dryrun.main(["--arch", "smollm-135m", "--shape",
                                   "train_4k", "--smoke", "--out",
                                   str(tmp_path / mode), "--perf", mode])
        want = dataclasses.asdict(perf.get())
        want.update({k: mode == "on" for k in MODE_FLAGS})
        assert recs[mode]["perf"] == want
    assert recs["off"]["hlo"]["bytes_per_dev"] != \
        recs["on"]["hlo"]["bytes_per_dev"]


# ----------------------------------------------------------- cache specs ----
STATES = {"default": {}, "baseline": None,
          "linear_local_caches": {"windowed_local_cache": False}}


def _flag_ctx(pkg, state):
    kw = STATES[state]
    return pkg.baseline() if kw is None else pkg.flags(**kw)


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_repro(arch, state):
    for smoke in (True, False):
        for shape in ("decode_32k", "long_500k"):
            s = get_shape(shape, smoke=smoke)
            with _flag_ctx(j_perf, state), _flag_ctx(perf, state):
                want = j_steps.cache_specs(j_get_config(arch, smoke),
                                           s.global_batch, s.seq_len)
                got = steps.cache_specs(get_config(arch, smoke),
                                        s.global_batch, s.seq_len)
            assert got.keys() == want.keys()
            for k, entries in want.items():
                assert got[k].keys() == entries.keys()
                for n, w in entries.items():
                    g = got[k][n]
                    assert g.device.type == "meta"
                    assert tuple(g.shape) == w.shape, (smoke, shape, k, n)
                    assert str(g.dtype)[6:] == str(w.dtype), (k, n)


# ------------------------------------------------- prefill + decode parity --
T, STEPS, B = 24, 4, 2
MAX_SEQ = T + STEPS + 4
ALL = list(ARCHS)
FLAG_CASES = [
    ("bf16_attn_io", {"bf16_attn_io": False},
     ["smollm-135m", "gemma2-9b", "zamba2-2.7b", "rwkv6-1.6b"]),
    ("rwkv_chunked", {"rwkv_chunked": False}, ["rwkv6-1.6b"]),
    ("rwkv_chunk", {"rwkv_chunk": 8}, ["rwkv6-1.6b"]),
    ("bf16_moe_dispatch", {"bf16_moe_dispatch": False},
     ["mixtral-8x7b", "llama4-maverick-400b-a17b"]),
    ("windowed_local_cache", {"windowed_local_cache": False},
     ["gemma2-9b", "mixtral-8x7b"]),
    ("baseline", None, ALL),
]
# bf16 runs where a flag changes bf16 numerics: the operand dtypes, and
# the baseline on the archs those flags touch
BF16 = {"bf16_attn_io", "bf16_moe_dispatch"}
BF16_BASELINE = {"smollm-135m", "gemma2-9b", "zamba2-2.7b", "rwkv6-1.6b",
                 "mixtral-8x7b", "llama4-maverick-400b-a17b"}
PARITY = [(name, arch, dtype) for name, _, archs in FLAG_CASES
          for arch in archs for dtype in ("float32", "bfloat16")
          if dtype == "float32" or name in BF16
          or (name == "baseline" and arch in BF16_BASELINE)]
KW = {name: kw for name, kw, _ in FLAG_CASES}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _err(got, want) -> float:
    return float(np.max(np.abs(_f32(got) - _f32(want))))


def _scale(want) -> float:
    return max(1.0, float(np.max(np.abs(_f32(want)))))


def _ctx(pkg, name):
    kw = KW[name]
    return pkg.baseline() if kw is None else pkg.flags(**kw)


def _inputs(cfg):
    rng = np.random.default_rng(20)
    if cfg.input_mode == "embeds":
        return rng.standard_normal((B, T + STEPS, cfg.d_model)).astype(
            np.float32)
    return rng.integers(0, cfg.vocab, (B, T + STEPS)).astype(np.int32)


def _batch(cfg, inp, lo, hi, pos=None):
    embeds = cfg.input_mode == "embeds"
    key = "embeds" if embeds else ("token" if pos is not None else "tokens")
    a = inp[:, lo:hi]
    t = torch.from_numpy(np.array(a))
    jb, tb = {key: jnp.asarray(a)}, {key: t if embeds else t.long()}
    if pos is not None:
        jb["pos"] = jnp.full((B,), pos, jnp.int32)
        tb["pos"] = torch.full((B,), pos, dtype=torch.int32)
    return jb, tb


def _check_caches(tc, jc, tol):
    assert tc.keys() == jc.keys()
    for key in jc:
        for n, want in jc[key].items():
            got = tc[key][n]
            assert tuple(got.shape) == want.shape, (key, n)
            assert _err(got, want) <= tol * _scale(want), (key, n)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch ops on one thread: under xdist the other workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,arch,dtype", PARITY,
                         ids=[f"{n}-{a}-{d}" for n, a, d in PARITY])
def test_flag_off_path_matches_repro(name, arch, dtype, monkeypatch):
    fp32 = dtype == "float32"
    if fp32:
        monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    tdt = torch.float32 if fp32 else torch.bfloat16
    tol = 1e-4 if fp32 else 2e-2
    jcfg = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jp = j_lm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(_np(jp), device="cpu")
    inp = _inputs(cfg)
    with _ctx(j_perf, name), _ctx(perf, name):
        jb, tb = _batch(cfg, inp, 0, T)
        jl, jc = j_lm.prefill(jcfg, jp, jb, max_seq=MAX_SEQ)
        tl, tc = t_lm.prefill(cfg, tp, tb, max_seq=MAX_SEQ, dtype=tdt)
        assert tl.dtype == tdt
        assert _err(tl, jl) <= tol * _scale(jl)
        _check_caches(tc, jc, tol)
        for i in range(STEPS if fp32 else 1):
            jb, tb = _batch(cfg, inp, T + i, T + i + 1, pos=T + i)
            jd, jc = j_lm.decode_step(jcfg, jp, jb, jc)
            td, tc = t_lm.decode_step(cfg, tp, tb, tc, dtype=tdt)
            assert _err(td, jd) <= tol * _scale(jd), i
        _check_caches(tc, jc, tol)


def test_bf16_attn_io_off_hands_the_kernels_fp32_copies(monkeypatch):
    """bf16 activations: flash and decode get bf16 operands under the
    default flags and fp32 copies without ``bf16_attn_io`` (the fp32
    instances on the card); the caches stay bf16 either way, and the
    outputs come back in bf16."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    seen = []
    for mod, name in ((fa, "flash_attention_plain"),
                      (da, "decode_attention_plain")):
        real = getattr(mod, name)

        def spy(q, k, v, *a, _real=real, _name=name, **kw):
            seen.append((_name, q.dtype, k.dtype, v.dtype))
            return _real(q, k, v, *a, **kw)
        monkeypatch.setattr(mod, name, spy)
    cfg = get_config("gemma2-9b", smoke=True)
    tp = t_lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    inp = _inputs(cfg)
    for io in (True, False):
        seen.clear()
        with perf.flags(bf16_attn_io=io):
            tl, tc = t_lm.prefill(cfg, tp, _batch(cfg, inp, 0, T)[1],
                                  max_seq=MAX_SEQ)
            td, tc = t_lm.decode_step(cfg, tp, _batch(cfg, inp, T, T + 1,
                                                      pos=T)[1], tc)
        want = torch.bfloat16 if io else torch.float32
        assert {s[0] for s in seen} == {"flash_attention_plain",
                                        "decode_attention_plain"}
        assert all(s[1:] == (want,) * 3 for s in seen), seen
        assert tl.dtype == td.dtype == torch.bfloat16
        assert all(v.dtype == torch.bfloat16 for c in tc.values()
                   for v in c.values())


@pytest.mark.parametrize("arch", ["mixtral-8x7b",
                                  "llama4-maverick-400b-a17b"])
def test_bf16_moe_dispatch_off_changes_no_logit(arch):
    """The combine tensor in fp32 (``bf16_moe_dispatch`` off) holds the
    same gates: each (token, expert, slot) has one, rounded once to bf16
    where it meets the bf16 expert outputs."""
    cfg = get_config(arch, smoke=True)
    tp = t_lm.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    toks = _batch(cfg, _inputs(cfg), 0, T)[1]
    on, _ = t_lm.prefill(cfg, tp, toks, max_seq=MAX_SEQ)
    with perf.flags(bf16_moe_dispatch=False):
        off, _ = t_lm.prefill(cfg, tp, toks, max_seq=MAX_SEQ)
    assert torch.equal(on, off)


def test_windowed_local_cache_off_holds_linear_caches():
    """Without the flag gemma2's local layers hold max_seq rows, written
    linearly (slot = position), where the default holds rings of the
    window."""
    cfg = get_config("gemma2-9b", smoke=True)
    tp = t_lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks = {"tokens": torch.from_numpy(_inputs(cfg)[:, :T]).long()}
    f32 = torch.float32
    _, ring = t_lm.prefill(cfg, tp, toks, max_seq=MAX_SEQ, dtype=f32)
    with perf.flags(windowed_local_cache=False):
        _, lin = t_lm.prefill(cfg, tp, toks, max_seq=MAX_SEQ, dtype=f32)
    assert ring["p0"]["k"].shape[2] == cfg.window
    assert lin["p0"]["k"].shape[2] == MAX_SEQ == lin["p1"]["k"].shape[2]
    w = cfg.window
    # ring slot p % W holds position p for the last W positions
    for p in range(T - w, T):
        assert torch.equal(ring["p0"]["k"][:, :, p % w],
                           lin["p0"]["k"][:, :, p])
    assert not lin["p0"]["k"][:, :, T:].any()


def test_rwkv_per_token_loss_and_gradients_match_repro(monkeypatch):
    """rwkv6 trained with ``rwkv_chunked`` off (the per-token WKV, a
    ``loops.scan``, through autograd), fp32 activations on both sides."""
    monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    jcfg = j_get_config("rwkv6-1.6b", smoke=True)
    cfg = get_config("rwkv6-1.6b", smoke=True)
    jp = j_lm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = lm_params_from_numpy(_np(jp), device="cpu", compute_copies=False)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    leaves, _ = flatten(tp)
    for p in leaves:
        p.requires_grad_(True)
    with j_perf.flags(rwkv_chunked=False), perf.flags(rwkv_chunked=False):
        jl, jg = jax.value_and_grad(
            lambda p: j_lm.loss_fn(jcfg, p, jb))(jp)
        tl = t_lm.loss_fn(cfg, tp, tb, dtype=torch.float32)
        tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    assert abs(tl.item() - float(jl)) <= 1e-4 * _scale(float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (g, want) in enumerate(zip(tg, jleaves)):
        want = np.asarray(want, np.float32)
        if g is None:
            assert not want.any(), i
            continue
        assert _err(g, want) <= 1e-4 * _scale(want), i


# --------------------------------------------------- TP-only serving specs --
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _repro_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_serving_param_specs_match_repro(arch, mesh_name):
    sizes = MESHES[mesh_name]
    jmesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes,
                                  devices=np.empty(tuple(sizes.values())))
    tmesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                  shape=tuple(sizes.values()))
    specs = {}
    for on in (False, True):
        with j_perf.flags(tp_serving_params=on), \
                perf.flags(tp_serving_params=on):
            want = _repro_specs(j_steps.make_decode_step(
                j_get_config(arch), jmesh, 4096, 128)["param_spec"])
            got = _port_specs(steps.make_decode_step(
                get_config(arch), tmesh, 4096, 128)["param_spec"])
        assert got == want
        specs[on] = got
    assert any(("data" in str(s)) for s in specs[False].values())
    assert not any(("data" in str(s)) for s in specs[True].values())


# ------------------------------------------------- the (2, 2) gloo mesh -----
MESH_T, MESH_B, TRAIN_T = 16, 4, 32
MESH_SEQ = MESH_T + 8
TP_ARCHS = ["granite-3-2b", "mixtral-8x7b"]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        d = out
        parts = k.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _serve(mesh, cfg, params, inp, flags):
    """(sharded, unsharded) fp32 prefill logits, caches and one decode
    step's logits, the flags on for both."""
    from repro_torch.launch import sharding

    pre = {"tokens": inp[:, :MESH_T]}
    dec = {"token": inp[:, MESH_T:MESH_T + 1],
           "pos": torch.full((inp.shape[0],), MESH_T, dtype=torch.int32)}
    f32 = torch.float32
    with perf.flags(**flags):
        ref_l, ref_c = t_lm.prefill(cfg, params, pre, MESH_SEQ, dtype=f32)
        ref_c0 = {k: {n: v.clone() for n, v in c.items()}
                  for k, c in ref_c.items()}
        ref_d, _ = t_lm.decode_step(cfg, params, dec, ref_c, dtype=f32)
        mk = steps.make_prefill(cfg, mesh, MESH_SEQ, dtype=f32)
        logits, cache = mk["fn"](sharding.distribute(params, mesh,
                                                     mk["param_spec"]), pre)
        full_c = {k: {n: v.full_tensor() for n, v in c.items()}
                  for k, c in cache.items()}
        dk = steps.make_decode_step(cfg, mesh, MESH_SEQ, inp.shape[0],
                                    dtype=f32)
        placed = sharding.distribute(params, mesh, dk["param_spec"])
        dl, _ = dk["fn"](placed, cache, dec)
    return {"prefill": logits.full_tensor(), "cache": full_c,
            "decode": dl.full_tensor(), "unsharded_prefill": ref_l,
            "unsharded_cache": ref_c0, "unsharded_decode": ref_d,
            "embed_placements": str(placed["embed"]["e"].placements)}


def _mesh_worker(rank: int, tmp: str):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        data = torch.load(os.path.join(tmp, "data.pt"), weights_only=False)
        res = {}
        for arch, d in data.items():
            cfg = get_config(arch, smoke=True)
            params = lm_params_from_numpy(_nest(d["params"]), device="cpu",
                                          compute_copies=False)
            inp = torch.from_numpy(d["inp"]).long()
            if arch == "mixtral-8x7b":
                res["flat_moe"] = _serve(mesh, cfg, params, inp,
                                         {"grouped_moe_dispatch": False})
                res["flat_moe_train"] = _train(mesh, cfg, d["params"],
                                               torch.from_numpy(d["train"]))
            res[f"tp_{arch}"] = _serve(mesh, cfg, params, inp,
                                       {"tp_serving_params": True})
        if rank == 0:
            torch.save(res, os.path.join(tmp, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _train(mesh, cfg, flat_params, toks):
    """(sharded, unsharded) fp32 loss of one step's batch, MoE routed flat
    (``grouped_moe_dispatch`` off)."""
    from repro_torch.launch import sharding

    def state(mk):
        p = lm_params_from_numpy(_nest(flat_params), device="cpu",
                                 compute_copies=False)
        return {"params": p, "opt": mk["opt"].init(p),
                "step": torch.zeros((), dtype=torch.int32)}

    batch = {"tokens": toks.long(), "labels": torch.roll(toks, -1, 1).long()}
    f32 = torch.float32
    with perf.flags(grouped_moe_dispatch=False):
        un = steps.make_train_step(cfg, "adamw", 1e-3, dtype=f32,
                                   device="cpu")
        _, m1 = un["fn"](state(un), batch)
        sh = steps.make_train_step(cfg, "adamw", 1e-3, mesh=mesh, dtype=f32,
                                   device="cpu")
        placed = sharding.distribute(state(sh), mesh, sh["state_spec"])
        _, tm = sh["fn"](placed, batch)
    return {"loss": float(tm["loss"]), "unsharded_loss": float(m1["loss"])}


@pytest.fixture(scope="module")
def on_mesh(tmp_path_factory):
    """Every mesh case in one spawned job; {case: (port results, repro
    reference)}."""
    tmp = tmp_path_factory.mktemp("gloo_perf")
    data, refs = {}, {}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
        for arch in TP_ARCHS:
            cfg = j_get_config(arch, smoke=True)
            params = j_lm.init_params(cfg, jax.random.PRNGKey(5))
            rng = np.random.default_rng(5)
            inp = rng.integers(0, cfg.vocab, (MESH_B, MESH_T + 1)).astype(
                np.int32)
            data[arch] = {"params": _flat(params), "inp": inp,
                          "train": rng.integers(0, cfg.vocab,
                                                (MESH_B, TRAIN_T)).astype(
                                                    np.int32)}
            if arch == "mixtral-8x7b":
                # no mesh: repro routes flat, as it does on a mesh without
                # grouped_moe_dispatch
                logits, cache = j_lm.prefill(
                    cfg, params, {"tokens": jnp.asarray(inp[:, :MESH_T])},
                    max_seq=MESH_SEQ)
                d, _ = j_lm.decode_step(cfg, params, {
                    "token": jnp.asarray(inp[:, MESH_T:MESH_T + 1]),
                    "pos": jnp.full((MESH_B,), MESH_T, jnp.int32)}, cache)
                refs["flat_moe"] = {
                    "prefill": np.asarray(logits, np.float32),
                    "cache": {k: {n: np.asarray(v, np.float32)
                                  for n, v in c.items()}
                              for k, c in cache.items()},
                    "decode": np.asarray(d, np.float32)}
    torch.save(data, tmp / "data.pt")
    mp.start_processes(_mesh_worker, args=(str(tmp),), nprocs=4,
                       start_method="spawn")
    res = torch.load(tmp / "results.pt", weights_only=False)
    return {k: (v, refs.get(k)) for k, v in res.items()}


def _tol(ref, rel: float = 1e-4) -> float:
    return rel * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


@pytest.mark.parametrize("case", ["flat_moe"] + [f"tp_{a}" for a in TP_ARCHS])
def test_sharded_serving_under_flags(on_mesh, case):
    got, ref = on_mesh[case]
    for name in ("prefill", "decode"):
        own = got[f"unsharded_{name}"]
        assert got[name].shape == own.shape
        assert _err(got[name], own) <= _tol(own), name
        if ref is not None:
            assert _err(got[name], ref[name]) <= _tol(ref[name]), name
    for k, entries in got["unsharded_cache"].items():
        for n, own in entries.items():
            assert _err(got["cache"][k][n], own) <= _tol(own), (k, n)
            if ref is not None:
                want = ref["cache"][k][n]
                assert _err(got["cache"][k][n], want) <= _tol(want), (k, n)
    if case.startswith("tp_"):
        # the embedding keeps only its 'model' sharding: Replicate on 'data'
        assert got["embed_placements"].startswith("(Replicate(),")


def test_sharded_flat_moe_train_loss(on_mesh):
    got, _ = on_mesh["flat_moe_train"]
    assert abs(got["loss"] - got["unsharded_loss"]) <= \
        _tol(got["unsharded_loss"])
