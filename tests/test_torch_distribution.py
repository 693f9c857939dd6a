"""The sharded steps of ``repro_torch.launch.steps`` in four ``gloo``
processes on a (2, 2) ('data', 'model') mesh, through the kernels' plain
versions, held in fp32 to the port's unsharded path and to ``repro``'s
unsharded ``lm.prefill``/``decode_step`` and ``loss_fn`` within 1e-4 x
max(1, max|ref|):

(RWKV-6 against ``repro`` within 2^-8 x max(1, max|ref|): both round the
chunked WKV's operands to bf16, and an operand next to a rounding boundary
can round the other way after fp32 sums taken in another order, which moves
the output by up to a bf16 step of that operand; the sharded port against
the unsharded port stays at 1e-4):

* prefill (logits and every cache entry) and one decode step for granite
  (dense GQA), gemma2 (local rings, soft-caps), mixtral (grouped MoE: the
  references group the tokens by 'model' shard, as ``repro`` does under
  such a mesh), zamba2 (hybrid), rwkv6, and granite at B 1 (long_500k's
  sequence-parallel caches, S over ('data', 'model'));
* one AdamW step: the loss and every updated param and moment;
* a checkpoint saved on the mesh restored unsharded, and the reverse.

All cases run in one spawned job (``_worker``; a ``FileStore`` under
``tmp_path``), whose rank 0 writes its results for the parametrised tests
to read.  ``repro``'s outputs are computed here, in the parent.  Beside
them, in this process: the plain flash with ``q_offset`` and the plain
decode with shard offsets and the log-sum-exp combine against the unsplit
plain versions, the (1, 1) smoke mesh (``repro``'s
``test_train_step_runs_on_smoke_mesh`` and
``test_decode_step_runs_on_smoke_mesh``), and the launchers' ``--mesh``.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

T, TRAIN_T = 16, 32
MAX_SEQ = T + 8            # divides by the 4 devices of a sequence-parallel
SERVE = [("granite-3-2b", 4), ("gemma2-9b", 4), ("mixtral-8x7b", 4),
         ("zamba2-2.7b", 4), ("rwkv6-1.6b", 4), ("granite-3-2b", 1)]
TRAIN_ARCH, TRAIN_B, LR = "smollm-135m", 4, 1e-3
MODEL_SHARDS = 2


def _tol(ref, rel: float = 1e-4) -> float:
    return rel * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _repro_rel(arch: str) -> float:
    """The tolerance against ``repro`` (module docstring)."""
    return 2.0 ** -8 if arch.startswith("rwkv6") else 1e-4


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


def _groups(t: int) -> int:
    """MoE token groups as under a mesh of MODEL_SHARDS 'model' shards
    (``repro``'s ``_group_for_shards``): by shard when each has two."""
    return MODEL_SHARDS if t % MODEL_SHARDS == 0 and \
        t >= 2 * MODEL_SHARDS else 1


# ------------------------------------------------------------ the worker ----
def _serve_case(mesh, arch, b, data):
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding, steps
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.convert import lm_params_from_numpy

    cfg = get_config(arch, smoke=True)
    params = lm_params_from_numpy(_nest(data["params"]), device="cpu",
                                  compute_copies=False)
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    inp = torch.from_numpy(data["inp"])
    pre = {key: inp[:, :T]}
    dec = {"pos": torch.full((b,), T, dtype=torch.int32),
           ("embeds" if key == "embeds" else "token"): inp[:, T:T + 1]}
    f32 = torch.float32
    real = moe_mod.moe_ffn
    moe_mod.moe_ffn = lambda p, x, **kw: real(p, x, groups=_groups(
        x.shape[1]), **kw)
    try:
        ref_l, ref_c = lm.prefill(cfg, params, pre, MAX_SEQ, dtype=f32)
        ref_c0 = {k: {n: v.clone() for n, v in c.items()}
                  for k, c in ref_c.items()}
        ref_d, _ = lm.decode_step(cfg, params, dec, ref_c, dtype=f32)
    finally:
        moe_mod.moe_ffn = real
    mk = steps.make_prefill(cfg, mesh, MAX_SEQ, dtype=f32)
    logits, cache = mk["fn"](sharding.distribute(params, mesh,
                                                 mk["param_spec"]), pre)
    full_l = logits.full_tensor()
    full_c = {k: {n: v.full_tensor() for n, v in c.items()}
              for k, c in cache.items()}
    dk = steps.make_decode_step(cfg, mesh, MAX_SEQ, b, dtype=f32)
    dl, _ = dk["fn"](sharding.distribute(params, mesh, dk["param_spec"]),
                     cache, dec)
    return {"prefill": full_l, "cache": full_c, "decode": dl.full_tensor(),
            "unsharded_prefill": ref_l, "unsharded_decode": ref_d,
            "unsharded_cache": ref_c0,
            "logit_placements": str(logits.placements),
            "cache_placements": {k: str(next(iter(c.values())).placements)
                                 for k, c in cache.items()}}


def _train_case(mesh, data, ckpt_dir):
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding, steps
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.pytree import flatten

    cfg = get_config(TRAIN_ARCH, smoke=True)
    f32 = torch.float32
    batch = {k: torch.from_numpy(v) for k, v in data["batch"].items()}

    def state():
        return lm_params_from_numpy(_nest(data["params"]), device="cpu",
                                    compute_copies=False)

    un = steps.make_train_step(cfg, "adamw", LR, dtype=f32, device="cpu")
    p = state()
    s0 = {"params": p, "opt": un["opt"].init(p),
          "step": torch.zeros((), dtype=torch.int32)}
    s1, m1 = un["fn"](s0, batch)
    sh = steps.make_train_step(cfg, "adamw", LR, mesh=mesh, dtype=f32,
                               device="cpu")
    p = state()
    placed = sharding.distribute(
        {"params": p, "opt": sh["opt"].init(p),
         "step": torch.zeros((), dtype=torch.int32)}, mesh, sh["state_spec"])
    t1, tm = sh["fn"](placed, batch)
    out = {"loss": float(tm["loss"]), "unsharded_loss": float(m1["loss"]),
           "params": {k: v.full_tensor() for k, v in
                      _flat_tensors(t1["params"]).items()},
           "unsharded_params": _flat_tensors(s1["params"]),
           "mu": {k: v.full_tensor() for k, v in
                  _flat_tensors(t1["opt"].mu).items()},
           "unsharded_mu": _flat_tensors(s1["opt"].mu)}

    # a checkpoint written on the mesh restores unsharded ...
    ckpt.save(os.path.join(ckpt_dir, "mesh"), 1, t1)
    dist.barrier()
    like = {"params": s1["params"], "opt": s1["opt"], "step": s1["step"]}
    back, _ = ckpt.restore(os.path.join(ckpt_dir, "mesh"), 1, like)
    a, _ = flatten(back)
    b, _ = flatten(t1)
    out["mesh_to_unsharded"] = all(
        type(x).__name__ == "Tensor" and torch.equal(x, y.full_tensor())
        for x, y in zip(a, b))
    # ... and one written unsharded restores onto the mesh
    if dist.get_rank() == 0:
        ckpt.save(os.path.join(ckpt_dir, "plain"), 1, s1)
    dist.barrier()
    shard = sharding.shardings(mesh, sh["state_spec"])
    onto, _ = ckpt.restore(os.path.join(ckpt_dir, "plain"), 1, like,
                           shardings=shard)
    a, _ = flatten(onto)
    b, _ = flatten(s1)
    out["unsharded_to_mesh"] = all(
        type(x).__name__ == "DTensor" and torch.equal(x.full_tensor(), y)
        for x, y in zip(a, b))
    out["placements_kept"] = all(
        tuple(x.placements) == tuple(y.placements)
        for x, y in zip(a, flatten(t1)[0]))
    return out


def _flat_tensors(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, path + (str(k),)))
        return out
    return {"/".join(path): tree.detach()}


def _worker(rank: int, tmp: str):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=4)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, MODEL_SHARDS), ("data", "model"),
                         device_type="cpu")
        results = {}
        for i, (arch, b) in enumerate(SERVE):
            data = torch.load(os.path.join(tmp, f"serve_{i}.pt"),
                              weights_only=False)
            results[f"serve_{i}"] = _serve_case(mesh, arch, b, data)
        data = torch.load(os.path.join(tmp, "train.pt"), weights_only=False)
        results["train"] = _train_case(mesh, data, tmp)
        if rank == 0:
            torch.save(results, os.path.join(tmp, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the parent ----
def _repro_serve(arch, b, monkeypatch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import lm as j_lm
    from repro.models import moe as j_moe

    monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(j_moe, "_group_for_shards", lambda x, t: _groups(t))
    cfg = j_get_config(arch, smoke=True)
    params = j_lm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(b)
    if cfg.input_mode == "embeds":
        inp = rng.standard_normal((b, T + 1, cfg.d_model)).astype(np.float32)
        key, dkey = "embeds", "embeds"
    else:
        inp = rng.integers(0, cfg.vocab, (b, T + 1)).astype(np.int32)
        key, dkey = "tokens", "token"
    logits, cache = j_lm.prefill(cfg, params, {key: jnp.asarray(inp[:, :T])},
                                 max_seq=MAX_SEQ)
    d, _ = j_lm.decode_step(cfg, params, {
        dkey: jnp.asarray(inp[:, T:T + 1]),
        "pos": jnp.full((b,), T, jnp.int32)}, cache)
    ref = {"prefill": np.asarray(logits, np.float32),
           "cache": {k: {n: np.asarray(v, np.float32) for n, v in c.items()}
                     for k, c in cache.items()},
           "decode": np.asarray(d, np.float32)}
    return {"params": _flat(params), "inp": inp}, ref


def _repro_train(monkeypatch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import lm as j_lm
    from repro.optim import make_optimizer as j_make_optimizer

    monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    cfg = j_get_config(TRAIN_ARCH, smoke=True)
    params = j_lm.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_T)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: j_lm.loss_fn(cfg, p, jb))(params)
    opt = j_make_optimizer("adamw", LR)
    new_params, new_opt = opt.update(grads, opt.init(params), params)
    ref = {"loss": float(loss), "params": _flat(new_params),
           "mu": _flat(new_opt.mu)}
    return {"params": _flat(params), "batch": batch}, ref


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Run every case once on the (2, 2) mesh; {name: (port results,
    repro reference)}."""
    tmp = tmp_path_factory.mktemp("gloo")
    refs = {}
    with pytest.MonkeyPatch.context() as mpatch:
        for i, (arch, b) in enumerate(SERVE):
            data, refs[f"serve_{i}"] = _repro_serve(arch, b, mpatch)
            torch.save(data, tmp / f"serve_{i}.pt")
        data, refs["train"] = _repro_train(mpatch)
        torch.save(data, tmp / "train.pt")
    mp.start_processes(_worker, args=(str(tmp),), nprocs=4,
                       start_method="spawn")
    results = torch.load(tmp / "results.pt", weights_only=False)
    return {k: (results[k], refs[k]) for k in refs}


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("case", range(len(SERVE)),
                         ids=[f"{a}-B{b}" for a, b in SERVE])
def test_sharded_prefill_and_decode(sharded, case):
    got, ref = sharded[f"serve_{case}"]
    rel = _repro_rel(SERVE[case][0])
    for name in ("prefill", "decode"):
        own = got[f"unsharded_{name}"]
        assert got[name].shape == tuple(own.shape) == np.shape(ref[name])
        assert _err(got[name], own) <= _tol(own), name
        assert _err(got[name], ref[name]) <= _tol(ref[name], rel), name
    for k, entries in ref["cache"].items():
        for n, want in entries.items():
            own = got["unsharded_cache"][k][n]
            assert _err(got["cache"][k][n], own) <= _tol(own), (k, n)
            assert _err(got["cache"][k][n], want) <= _tol(want, rel), (k, n)


def test_sharded_placements(sharded):
    """Logits come out with repro's spec, the vocab over 'model'; the KV
    caches by batch and S at B 4, S over both axes at B 1."""
    got, _ = sharded["serve_0"]
    assert got["logit_placements"] == "(Shard(dim=0), Shard(dim=2))"
    assert got["cache_placements"]["p0"] == "(Shard(dim=1), Shard(dim=2))"
    got, _ = sharded[f"serve_{len(SERVE) - 1}"]
    assert got["logit_placements"] == "(Replicate(), Shard(dim=2))"
    assert got["cache_placements"]["p0"] == "(Shard(dim=2), Shard(dim=2))"


def test_sharded_train_step(sharded):
    got, ref = sharded["train"]
    assert abs(got["loss"] - ref["loss"]) <= _tol(ref["loss"])
    assert abs(got["loss"] - got["unsharded_loss"]) <= _tol(ref["loss"])
    for tree in ("params", "mu"):
        assert got[tree].keys() == ref[tree].keys()
        for k, want in ref[tree].items():
            assert _err(got[tree][k], want) <= _tol(want), (tree, k)
            assert _err(got[tree][k], got[f"unsharded_{tree}"][k]) <= \
                _tol(want), (tree, k)


@pytest.mark.parametrize("direction", ["mesh_to_unsharded",
                                       "unsharded_to_mesh",
                                       "placements_kept"])
def test_checkpoint_across_meshes(sharded, direction):
    assert sharded["train"][0][direction]


# -------------------------------------------------- the plain splits --------
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 20.0)])
def test_plain_flash_q_offset_splits(n, window, softcap):
    from repro_torch.kernels.flash_attention import (
        flash_attention_grads,
        flash_attention_plain,
    )
    rng = np.random.default_rng(n)
    t, h, kh, dh = 24, 4, 2, 16
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, t, h, dh), (2, t, kh, dh), (2, t, kh, dh),
                            (2, t, h, dh)))
    kw = dict(window=window, softcap=softcap)
    whole = flash_attention_plain(q, k, v, **kw)
    dq, dk, dv = flash_attention_grads(q, k, v, g, **kw)
    rows = t // n
    parts, gk, gv = [], torch.zeros_like(k), torch.zeros_like(v)
    for i in range(n):
        q0, end = i * rows, (i + 1) * rows
        parts.append(flash_attention_plain(q[:, q0:end], k[:, :end],
                                           v[:, :end], q_offset=q0, **kw))
        a, b, c = flash_attention_grads(q[:, q0:end], k[:, :end], v[:, :end],
                                        g[:, q0:end], q_offset=q0, **kw)
        assert torch.allclose(a, dq[:, q0:end], atol=1e-5)
        gk[:, :end] += b
        gv[:, :end] += c
    assert torch.allclose(torch.cat(parts, dim=1), whole, atol=1e-6)
    assert torch.allclose(gk, dk, atol=1e-5)
    assert torch.allclose(gv, dv, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("window,pos", [(0, (0, 31, 9, 17)),
                                        (6, (3, 31, 20, 8))])
def test_plain_decode_shards_combine(n, window, pos):
    """Shards at their offsets, combined by their log-sum-exps, give the
    unsplit output; a shard that sees no row has lse -inf and output 0."""
    from repro_torch.kernels.decode_attention import (
        combine_shards,
        decode_attention_plain,
    )
    rng = np.random.default_rng(n)
    b, s, h, kh, dh = 4, 32, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((b, s, kh, dh)).astype(
        np.float32)) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32)
    whole = decode_attention_plain(q, ck, cv, p, window=window)
    rows = s // n
    outs, lses = [], []
    for i in range(n):
        o, l = decode_attention_plain(q, ck[:, i * rows:(i + 1) * rows],
                                      cv[:, i * rows:(i + 1) * rows], p,
                                      window=window, k_offset=i * rows,
                                      return_lse=True)
        lo, hi = i * rows, i * rows + rows - 1
        seen = [lo <= x and (window <= 0 or hi > x - window) for x in pos]
        for row, ok in enumerate(seen):
            if not ok:
                assert torch.isneginf(l[row]).all()
                assert torch.equal(o[row], torch.zeros_like(o[row]))
        outs.append(o)
        lses.append(l)
    got = combine_shards(torch.stack(outs), torch.stack(lses))
    assert torch.isfinite(got).all()
    assert torch.allclose(got, whole, atol=1e-6)


# ---------------------------------------------------- the (1, 1) mesh -------
@pytest.fixture
def smoke_mesh():
    from repro_torch.launch.mesh import make_smoke_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_smoke_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_train_step_runs_on_smoke_mesh(smoke_mesh):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    cfg = get_config("smollm-135m", smoke=True)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    kw = dict(dtype=torch.float32, device="cpu")
    un = steps.make_train_step(cfg, "adamw", LR, **kw)
    sh = steps.make_train_step(cfg, "adamw", LR, mesh=smoke_mesh, **kw)
    s_un, s_sh = un["make_init"](0)(), sh["make_init"](0)()
    for _ in range(2):
        s_un, m_un = un["fn"](s_un, batch)
        s_sh, m_sh = sh["fn"](s_sh, batch)
        assert torch.isfinite(m_sh["loss"])
        assert abs(float(m_sh["loss"]) - float(m_un["loss"])) <= 1e-5
    assert int(s_sh["step"].full_tensor()) == 2


def test_decode_step_runs_on_smoke_mesh(smoke_mesh):
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding, steps
    from repro_torch.models import lm
    cfg = get_config("zamba2-2.7b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)).astype(
        np.int32))
    f32 = torch.float32
    ref_l, ref_c = lm.prefill(cfg, params, {"tokens": toks[:, :8]}, 12,
                              dtype=f32)
    pre = steps.make_prefill(cfg, smoke_mesh, 12, dtype=f32)
    dec = steps.make_decode_step(cfg, smoke_mesh, 12, 2, dtype=f32)
    placed = sharding.distribute(params, smoke_mesh, dec["param_spec"])
    logits, cache = pre["fn"](placed, {"tokens": toks[:, :8]})
    assert torch.equal(logits.full_tensor(), ref_l)
    batch = {"token": toks[:, 8:9], "pos": torch.full((2,), 8,
                                                      dtype=torch.int32)}
    want, _ = lm.decode_step(cfg, params, batch, ref_c, dtype=f32)
    got, cache = dec["fn"](placed, cache, batch)
    assert tuple(got.shape) == (2, 1, cfg.vocab)
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(cache["shared"]["k"].full_tensor(),
                       ref_c["shared"]["k"])


# ---------------------------------------------------------- the launchers ---
@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_run_on_the_smoke_mesh(launcher, tmp_path):
    """``--mesh smoke`` runs the sharded steps on a (1, 1) mesh in one
    process (a subprocess here: the launcher keeps its process group)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
            "--mesh", "smoke"]
    if launcher == "train":
        args += ["--steps", "2", "--ckpt-dir", str(tmp_path / "ckpt"),
                 "--seq-len", "16", "--batch", "2"]
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("sample:" if launcher == "serve" else "done at step 2") \
        in out.stdout


def test_production_meshes_need_torchrun(monkeypatch):
    from repro_torch.launch.mesh import mesh_from_flag
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="256 processes"):
        mesh_from_flag("single", device_type="cpu")
    with pytest.raises(SystemExit, match="512 processes"):
        mesh_from_flag("multi", device_type="cpu")
