"""Atomic, async checkpointing (port of ``repro.checkpoint``), in
``repro``'s format.

Layout::

    <dir>/step_<N>/
        manifest.msgpack              tree, leaf count, codec, metadata
        shard_<host>.msgpack.{zst,zlib}   this host's leaves

* **Atomicity**: written to ``step_<N>.tmp``, then renamed; ``latest_step``
  never sees a ``.tmp``.
* **Async drain**: ``save_async`` copies the leaves to host memory now and
  writes them on a background thread; ``wait_pending`` joins the writers.
* **Same bytes as ``repro``**: leaves in ``jax.tree`` order
  (``repro_torch.pytree``), each ``{"dtype", "shape", "data"}`` with bf16
  viewed as uint16, packed by ``msgpack``; the codec (zstd when
  ``zstandard`` imports, else zlib) is tagged in the manifest and the
  shard's name.  A checkpoint written by either package restores in the
  other.

zlib deflates at about 20 MB/s a core (measured on the H100 machine's
host), slow for a model's state, so the port deflates 64 MiB pieces on all
cores, each piece its own run of deflate blocks ending on a byte boundary
(the way ``pigz`` does): the pieces joined are one ordinary zlib stream, which
``repro`` reads.  The manifest lists the pieces' compressed ends
(``zlib_pieces``, a key ``repro`` ignores), so the port inflates them on all
cores too.
"""
from __future__ import annotations

import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import msgpack
import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..pytree import flatten, unflatten

try:                       # optional: faster and smaller than stdlib zlib
    import zstandard
except ImportError:
    zstandard = None

_DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"
_ZLIB_LEVEL = 3            # repro's
_ZLIB_PIECE = 64 << 20     # bytes of payload deflated as one piece


def _workers() -> int:
    return os.cpu_count() or 1


def _zlib_compress(data: bytes) -> tuple[bytes, list[int]]:
    """(one zlib stream of ``data``, the compressed end of each piece)."""
    view = memoryview(data)
    starts = range(0, max(len(data), 1), _ZLIB_PIECE)

    def piece(i: int) -> bytes:
        c = zlib.compressobj(_ZLIB_LEVEL, zlib.DEFLATED, -15)
        last = i == len(starts) - 1
        return c.compress(view[starts[i]:starts[i] + _ZLIB_PIECE]) + \
            c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    with ThreadPoolExecutor(min(len(starts), _workers())) as ex:
        pieces = list(ex.map(piece, range(len(starts))))
    header = zlib.compress(b"", _ZLIB_LEVEL)[:2]
    ends, n = [], len(header)
    for p in pieces:
        n += len(p)
        ends.append(n)
    return (header + b"".join(pieces)
            + zlib.adler32(data).to_bytes(4, "big")), ends


def _zlib_decompress(blob: bytes, ends: list[int] | None) -> bytes:
    if not ends:
        return zlib.decompress(blob)
    bounds = list(zip([2] + ends[:-1], ends))
    view = memoryview(blob)

    def piece(b):
        d = zlib.decompressobj(-15)
        return d.decompress(view[b[0]:b[1]]) + d.flush()

    with ThreadPoolExecutor(min(len(bounds), _workers())) as ex:
        data = b"".join(ex.map(piece, bounds))
    if zlib.adler32(data) != int.from_bytes(blob[ends[-1]:ends[-1] + 4],
                                            "big"):
        raise ValueError("checkpoint shard: zlib checksum mismatch")
    return data


def _compress(data: bytes, codec: str) -> tuple[bytes, list[int] | None]:
    if codec == "zstd":
        if zstandard is None:
            raise ModuleNotFoundError(
                "checkpoint codec 'zstd' requires the zstandard package; "
                "save with codec='zlib'")
        return zstandard.ZstdCompressor(level=3, threads=-1).compress(data), \
            None
    if codec == "zlib":
        return _zlib_compress(data)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompress(data: bytes, codec: str, pieces) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise ModuleNotFoundError(
                "this checkpoint was written with zstd; the zstandard "
                "package is required to restore it")
        return zstandard.ZstdDecompressor().decompress(data)
    if codec == "zlib":
        return _zlib_decompress(data, pieces)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _shard_name(host_id: int, codec: str) -> str:
    ext = {"zstd": "zst", "zlib": "zlib"}[codec]
    return f"shard_{host_id:05d}.msgpack.{ext}"


def _host_array(x) -> np.ndarray:
    """A leaf as a numpy array on the host; bf16 viewed as uint16.  A
    DTensor is written whole (gathered), as ``repro``'s format holds it."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _leaf_to_bytes(x) -> dict:
    bf16 = (x.dtype == torch.bfloat16 if isinstance(x, torch.Tensor)
            else getattr(getattr(x, "dtype", None), "name", "") == "bfloat16")
    arr = _host_array(x)
    if bf16:
        arr = arr.view(np.uint16)
    return {"dtype": "bfloat16" if bf16 else str(arr.dtype),
            "shape": list(arr.shape), "data": arr.tobytes()}


def _leaf_from_bytes(d: dict, like):
    """A leaf: a tensor on ``like``'s device where ``like`` is a tensor, a
    numpy array otherwise (as ``repro`` returns; bf16 as a CPU tensor)."""
    bf16 = d["dtype"] == "bfloat16"
    arr = np.frombuffer(d["data"], dtype=np.int16 if bf16 else d["dtype"]
                        ).reshape(d["shape"])
    t = torch.from_numpy(arr.copy())
    if bf16:
        t = t.view(torch.bfloat16)
    if not isinstance(like, torch.Tensor):
        return t if bf16 else t.numpy()     # numpy has no bf16 of its own
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {tuple(t.shape)} {t.dtype} does "
                         f"not match {tuple(like.shape)} {like.dtype}")
    return t.to(like.device)


def save(ckpt_dir: str, step: int, tree: Any, metadata: dict | None = None,
         host_id: int = 0, codec: str | None = None) -> str:
    """Synchronous atomic save.  Returns the final directory.

    DTensor leaves are gathered whole (every process of their mesh must
    call ``save``), and then only global rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    codec = codec or _DEFAULT_CODEC
    leaves, treedef = flatten(tree)
    sharded = any(isinstance(x, DTensor) for x in leaves)
    data = [_leaf_to_bytes(x) for x in leaves]
    if sharded and torch.distributed.get_rank() != 0:
        return final
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    blob, pieces = _compress(msgpack.packb(data), codec)
    with open(os.path.join(tmp, _shard_name(host_id, codec)), "wb") as f:
        f.write(blob)
    manifest = {"step": step, "treedef": repr(treedef),
                "n_leaves": len(leaves), "codec": codec,
                "metadata": metadata or {}}
    if pieces:
        manifest["zlib_pieces"] = pieces
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


_pending: list[threading.Thread] = []
_pending_lock = threading.Lock()


def save_async(ckpt_dir: str, step: int, tree: Any,
               metadata: dict | None = None) -> threading.Thread:
    """Copy the leaves to host memory now (DTensors gathered whole);
    write them in the background."""
    leaves, treedef = flatten(tree)
    sharded = any(isinstance(x, DTensor) for x in leaves)
    snapshot = unflatten(treedef, [
        (x.full_tensor() if isinstance(x, DTensor) else x).detach().to(
            "cpu", copy=True) if isinstance(x, torch.Tensor)
        else np.array(x) for x in leaves])
    write = not sharded or torch.distributed.get_rank() == 0
    t = threading.Thread(target=save if write else (lambda *a: None),
                         args=(ckpt_dir, step, snapshot, metadata),
                         daemon=True)
    t.start()
    with _pending_lock:
        _pending.append(t)
    return t


def wait_pending():
    with _pending_lock:
        threads = list(_pending)
        _pending.clear()
    for t in threads:
        t.join()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, host_id: int = 0,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: tensor leaves of ``like``
    give tensors on their device (shape and dtype checked), other leaves
    numpy arrays.  ``shardings`` (a tree of ``like``'s structure whose
    leaves have ``mesh`` and ``placements``, e.g.
    ``launch.sharding.NamedSharding``) distributes each leaf onto its mesh,
    as ``repro``'s ``device_put``; a checkpoint written on one mesh (or
    none) restores onto another.  Returns (tree, metadata)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    codec = manifest.get("codec", "zstd")   # pre-tag checkpoints were zstd
    with open(os.path.join(final, _shard_name(host_id, codec)), "rb") as f:
        payload = msgpack.unpackb(_decompress(
            f.read(), codec, manifest.get("zlib_pieces")))
    like_leaves, treedef = flatten(like)
    if not len(payload) == len(like_leaves) == manifest["n_leaves"]:
        raise ValueError(f"checkpoint holds {len(payload)} leaves "
                         f"(manifest {manifest['n_leaves']}), the tree to "
                         f"restore into {len(like_leaves)}")
    leaves = [_leaf_from_bytes(d, x) for d, x in zip(payload, like_leaves)]
    if shardings is not None:
        sh, _ = flatten(shardings)
        if len(sh) != len(leaves):
            raise ValueError(f"restore: {len(sh)} shardings for "
                             f"{len(leaves)} leaves")
        leaves = [distribute_tensor(x, s.mesh, s.placements,
                                    src_data_rank=None)
                  for x, s in zip(leaves, sh)]
    return unflatten(treedef, leaves), manifest["metadata"]
