"""Port parity: checkpoints in ``repro``'s format.

A checkpoint written by either package must restore in the other leaf for
leaf, exactly (bf16 as its bits), with either codec, and the two packages'
shards must hold the same payload bytes; the pytree order must be
``jax.tree``'s.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.checkpoint import checkpoint as j_ckpt_mod
from repro.optim.optimizers import AdamState as JAdamState
from repro_torch import checkpoint as t_ckpt
from repro_torch import pytree
from repro_torch.checkpoint import checkpoint as t_ckpt_mod
from repro_torch.optim import AdamState

CODECS = ["zstd", "zlib"]


def _trees():
    """The same train-state-like tree for both packages: nested dicts, a
    NamedTuple, bf16, int32 and 0-d leaves, a None node."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    e = rng.standard_normal((7, 4)).astype(np.float32)
    m = rng.standard_normal((3, 5)).astype(np.float32)
    j = {"params": {"w": jnp.asarray(w), "emb": {"e": jnp.asarray(e, jnp.bfloat16)}},
         "opt": JAdamState(jnp.int32(3), {"w": jnp.asarray(m)},
                           {"w": jnp.asarray(m * m)}),
         "step": jnp.int32(3), "none": None}
    bf = torch.from_numpy(e).to(torch.bfloat16)
    t = {"params": {"w": torch.from_numpy(w), "emb": {"e": bf}},
         "opt": AdamState(torch.tensor(3, dtype=torch.int32),
                          {"w": torch.from_numpy(m)},
                          {"w": torch.from_numpy(m * m)}),
         "step": torch.tensor(3, dtype=torch.int32), "none": None}
    return j, t


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_flatten_order_is_jax_trees():
    j, t = _trees()
    jl, jd = jax.tree_util.tree_flatten(j)
    tl, td = pytree.flatten(t)
    assert len(jl) == len(tl) == 6
    for a, b in zip(jl, tl):
        assert np.array_equal(_bits(a), _bits(b))
    again = pytree.unflatten(td, tl)
    assert isinstance(again["opt"], AdamState) and again["none"] is None
    assert pytree.flatten(again)[1] == td


def test_tree_map_keeps_the_structure_and_refuses_another():
    """``pytree.tree_map`` (the port's one tree map: params, states,
    gradients) maps leaves only, keeps dicts, NamedTuples and None, and
    refuses trees of another structure."""
    _, t = _trees()
    doubled = pytree.tree_map(lambda a: a * 2, t)
    assert isinstance(doubled["opt"], AdamState) and doubled["none"] is None
    assert pytree.flatten(doubled)[1] == pytree.flatten(t)[1]
    for a, b in zip(pytree.leaves(t), pytree.leaves(doubled)):
        assert torch.equal(a * 2, b)
    summed = pytree.tree_map(lambda a, b: a + b, t, doubled)
    assert torch.equal(summed["params"]["w"], t["params"]["w"] * 3)
    with pytest.raises(ValueError, match="structures differ"):
        pytree.tree_map(lambda a, b: a, t["params"], {"w": t["params"]["w"]})


@pytest.mark.parametrize("codec", CODECS)
def test_roundtrip_with_bf16(tmp_path, codec):
    _, t = _trees()
    t_ckpt_mod.save(str(tmp_path), 42, t, {"step": 42, "data_index": 13},
                    codec=codec)
    assert t_ckpt.latest_step(str(tmp_path)) == 42
    got, meta = t_ckpt.restore(str(tmp_path), 42, t)
    assert meta == {"step": 42, "data_index": 13}
    assert got["params"]["emb"]["e"].dtype == torch.bfloat16
    assert isinstance(got["opt"], AdamState)
    for a, b in zip(pytree.leaves(t), pytree.leaves(got)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_zlib_pieces_make_one_stream(tmp_path, monkeypatch):
    """The pieces deflated apart join into one zlib stream that plain
    ``zlib.decompress`` (so ``repro``) reads; restore inflates the pieces
    apart and checks the stream's checksum."""
    import zlib
    monkeypatch.setattr(t_ckpt_mod, "_ZLIB_PIECE", 100)
    _, t = _trees()
    final = t_ckpt_mod.save(str(tmp_path), 1, t, codec="zlib")
    with open(os.path.join(final, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    assert manifest["codec"] == "zlib" and len(manifest["zlib_pieces"]) > 3
    shard = os.path.join(final, "shard_00000.msgpack.zlib")
    with open(shard, "rb") as f:
        blob = f.read()
    payload = msgpack.unpackb(zlib.decompress(blob))
    assert len(payload) == manifest["n_leaves"]
    with open(shard, "wb") as f:               # a flipped byte is caught
        f.write(blob[:-1] + bytes([blob[-1] ^ 1]))
    with pytest.raises(ValueError, match="checksum"):
        t_ckpt.restore(str(tmp_path), 1, t)


def test_atomic_no_partial(tmp_path):
    t_ckpt.save(str(tmp_path), 1, {"w": torch.zeros(8)})
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert t_ckpt.latest_step(str(tmp_path)) == 1
    assert t_ckpt.latest_step(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("codec", CODECS)
def test_repro_checkpoint_restores_in_the_port(tmp_path, codec):
    j, t = _trees()
    j_ckpt_mod.save(str(tmp_path), 5, j, {"step": 5, "data_index": 9},
                    codec=codec)
    got, meta = t_ckpt.restore(str(tmp_path), 5, t)
    assert meta == {"step": 5, "data_index": 9}
    for a, b in zip(jax.tree_util.tree_leaves(j), pytree.leaves(got)):
        assert np.array_equal(_bits(a), _bits(b))
    assert got["params"]["emb"]["e"].dtype == torch.bfloat16


@pytest.mark.parametrize("codec", CODECS)
def test_port_checkpoint_restores_in_repro(tmp_path, codec):
    j, t = _trees()
    t_ckpt_mod.save(str(tmp_path), 6, t, {"step": 6, "data_index": 2},
                    codec=codec)
    got, meta = j_ckpt.restore(str(tmp_path), 6, j)
    assert meta == {"step": 6, "data_index": 2}
    for a, b in zip(pytree.leaves(t), jax.tree_util.tree_leaves(got)):
        assert np.asarray(b).dtype.name == str(a.dtype).removeprefix("torch.")
        assert np.array_equal(_bits(a), _bits(b))


def test_save_async_snapshots_before_the_next_update(tmp_path):
    w = torch.arange(6, dtype=torch.float32)
    t_ckpt.save_async(str(tmp_path), 1, {"w": w})
    w.add_(100.0)                      # the next step updates in place
    t_ckpt.wait_pending()
    got, _ = t_ckpt.restore(str(tmp_path), 1, {"w": w})
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


def test_restore_refuses_a_tree_that_does_not_fit(tmp_path):
    t_ckpt.save(str(tmp_path), 1, {"w": torch.zeros(8)})
    with pytest.raises(ValueError, match="leaves"):
        t_ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(8),
                                          "v": torch.zeros(2)})
    with pytest.raises(ValueError, match="does not match"):
        t_ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(9)})


@pytest.mark.parametrize("codec", CODECS)
def test_both_packages_write_the_same_payload(tmp_path, codec):
    """The shards of one tree, written by each package, inflate to the same
    bytes: the same leaf order, dicts and dtypes, packed alike."""
    j, t = _trees()
    payloads = []
    for final in (j_ckpt_mod.save(str(tmp_path / "j"), 1, j, codec=codec),
                  t_ckpt_mod.save(str(tmp_path / "t"), 1, t, codec=codec)):
        with open(os.path.join(final, t_ckpt_mod._shard_name(0, codec)),
                  "rb") as f:
            # no piece list: the port's zlib shard inflates as one stream
            payloads.append(t_ckpt_mod._decompress(f.read(), codec, None))
    assert len(payloads[0]) > 0 and payloads[0] == payloads[1]
