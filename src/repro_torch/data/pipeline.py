"""Synthetic tokenized data pipeline: deterministic, sharded, prefetched
(port of ``repro.data.pipeline``).

* **Deterministic cursor**: batch ``i`` is a pure function of (seed, i,
  host), so a restart from a checkpoint resumes the exact stream, and any
  host can produce any shard.
* **Host sharding**: each host materialises only its slice of the global
  batch.
* **Pull-based prefetch**: a background thread keeps a bounded queue full.

The dataset is numpy, drawn exactly as ``repro``'s, so its batches are
bit-identical to ``repro``'s for every (seed, index, host); the stream is a
Zipf mixture with injected copy motifs.  ``to_device`` is the loader's last
step: it moves one batch onto the device as tensors (token ids as int64,
the index type of the port's embedding).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..observability import events


class SyntheticTokenDataset:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, input_mode: str = "tokens", d_model: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.input_mode = input_mode
        self.d_model = d_model
        # Zipf-ish unigram distribution
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, index: int, host_id: int = 0, num_hosts: int = 1) -> dict:
        """The ``host_id``-th slice of global batch ``index`` (numpy)."""
        if self.global_batch % num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {num_hosts} hosts")
        local = self.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index, host_id]))
        toks = rng.choice(self.vocab, size=(local, self.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # inject copy motifs (span repeats) so sequences have structure
        span = max(4, self.seq_len // 64)
        if self.seq_len > 3 * span:          # short sequences: skip motifs
            for b in range(local):
                # dst + span <= seq_len for every (src, jitter) choice
                src = int(rng.integers(0, self.seq_len - 3 * span + 1))
                dst = src + span + int(rng.integers(0, span))
                toks[b, dst:dst + span] = toks[b, src:src + span]
        out = {"labels": toks[:, 1:]}
        if self.input_mode == "embeds":
            emb = rng.standard_normal((local, self.seq_len, self.d_model))
            out["embeds"] = emb.astype(np.float32)
        else:
            out["tokens"] = toks[:, :-1]
        return out


def to_device(batch: dict, device) -> dict:
    """One numpy batch as tensors on ``device``: int32 ids become int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device)
    return out


class PrefetchIterator:
    """Bounded-queue background prefetch over a deterministic dataset;
    ``index`` is the cursor of the next batch (checkpointed)."""

    def __init__(self, dataset: SyntheticTokenDataset, start_index: int = 0,
                 depth: int = 2, host_id: int = 0, num_hosts: int = 1):
        self.dataset = dataset
        self.index = start_index
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._host = (host_id, num_hosts)
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        i = self.index
        try:
            while not self._stop.is_set():
                b = self.dataset.batch(i, *self._host)
                while not self._stop.is_set():
                    try:
                        self._q.put((i, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                i += 1
        except Exception as e:  # noqa: BLE001 — surfaced to the consumer
            self._err = e
            if events.enabled():
                events.emit("data.worker_error", index=i,
                            error=f"{type(e).__name__}: {e}")

    def __next__(self):
        while True:
            if self._err is not None:
                raise RuntimeError("data pipeline worker failed") from self._err
            try:
                i, b = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                continue
        self.index = i + 1   # cursor of the NEXT batch (checkpointable)
        return b

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        if events.enabled():
            events.emit("data.closed", index=self.index)
