"""The port's continuous-batching scheduler (``repro_torch.serving``)
against ``repro.serving.scheduler.ContinuousBatcher`` and against its own
sequential generation, mirroring ``tests/test_serving.py``.

Against ``repro`` (same numpy weights and prompts, an event log installed
in each): the same events in the same order (kinds, request ids, slots,
prompt and token counts, queue depths; timestamps aside), the same
counters, the same completion order.  Scheduling depends on prompt lengths
and budgets, not on token values, so these are exact.  Tokens are held to
the port's own sequential generation, exactly, as ``tests/test_serving.py``
holds ``repro``'s: the same engine fed the same tokens.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro.observability import events as j_events
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.models import lm as t_lm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.observability import events as t_events
from repro_torch.serving import ContinuousBatcher, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    jcfg = j_get_config(arch, smoke=True)
    jp = j_lm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, get_config(arch, smoke=True), jp, tp


def _greedy_single(cfg, params, prompt, n_new, max_seq):
    logits, cache = t_lm.prefill(cfg, params, {"tokens": prompt[None]},
                                 max_seq=max_seq)
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = prompt.shape[0]
    for _ in range(n_new - 1):
        batch = {"token": torch.tensor([[toks[-1]]]),
                 "pos": torch.tensor([pos], dtype=torch.int32)}
        logits, cache = t_lm.decode_step(cfg, params, batch, cache)
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return toks


def _events(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("ts")
        out.append(rec)
    return out


# mixtral's smoke window is 16: prompts of 20 and 27 tokens roll its ring
# at prefill, and decode wraps it at a different step in each row
@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b",
                                  "rwkv6-1.6b", "gemma2-9b"])
def test_events_counters_and_order_match_repro(arch, tmp_path):
    jcfg, cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), budget)
            for n, budget in ((20, 5), (7, 3), (27, 6), (12, 2), (9, 4))]
    max_seq = 32

    jb = JBatcher(jcfg, jp, batch_slots=2, max_seq=max_seq)
    j_events.install(str(tmp_path / "repro.jsonl"))
    try:
        for i, (p, n) in enumerate(reqs):
            jb.submit(JRequest(rid=i, prompt=jnp.asarray(p),
                               max_new_tokens=n))
        jdone = jb.run()
    finally:
        j_events.uninstall()

    tb = ContinuousBatcher(cfg, tp, batch_slots=2, max_seq=max_seq)
    t_events.install(str(tmp_path / "port.jsonl"))
    try:
        for i, (p, n) in enumerate(reqs):
            tb.submit(Request(rid=i, prompt=torch.from_numpy(p).long(),
                              max_new_tokens=n))
        tdone = tb.run()
    finally:
        t_events.uninstall()

    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [len(r.generated) for r in tdone] == \
        [len(r.generated) for r in jdone]
    assert _events(tmp_path / "port.jsonl") == \
        _events(tmp_path / "repro.jsonl")
    assert tb.stats()["counters"] == jb.stats()["counters"]
    assert tb.stats()["slot_occupancy"] == jb.stats()["slot_occupancy"]
    # every request admitted once and completed once
    kinds = [e["kind"] for e in _events(tmp_path / "port.jsonl")]
    assert kinds.count("scheduler.admit") == len(reqs)
    assert kinds.count("scheduler.complete") == len(reqs)
    assert kinds.count("scheduler.evict") == len(reqs)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b",
                                  "rwkv6-1.6b"])
def test_continuous_batching_matches_sequential(arch):
    _, cfg, _, tp = _setup(arch)
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g)
               for n in (8, 19, 11)]
    batcher = ContinuousBatcher(cfg, tp, batch_slots=2, max_seq=32)
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    done = batcher.run()
    assert len(done) == 3
    assert all(len(r.generated) == 5 for r in done)
    for r in done:   # every request, the queued one admitted into reuse too
        assert r.generated == _greedy_single(cfg, tp, prompts[r.rid], 5, 32)


def test_slot_reuse_admits_queued_requests():
    _, cfg, _, tp = _setup("smollm-135m")
    batcher = ContinuousBatcher(cfg, tp, batch_slots=1, max_seq=32)
    for i in range(2):   # 2 requests through 1 slot -> forced reuse
        batcher.submit(Request(rid=i, prompt=torch.arange(4) + i,
                               max_new_tokens=3))
    done = batcher.run()
    assert sorted(r.rid for r in done) == [0, 1]


def test_token_accounting_counts_every_emitted_token():
    _, cfg, _, tp = _setup("smollm-135m")
    batcher = ContinuousBatcher(cfg, tp, batch_slots=2, max_seq=32)
    for i in range(3):
        batcher.submit(Request(rid=i, prompt=torch.arange(4) + i,
                               max_new_tokens=4))
    done = batcher.run()
    assert len(done) == 3
    stats = batcher.stats()
    c = stats["counters"]
    emitted = sum(len(r.generated) for r in done)
    assert c["prefill_tokens_emitted"] == 3
    assert c["tokens_generated"] + c["prefill_tokens_emitted"] == emitted
    pre = batcher.metrics.latencies["prefill"]
    dec = batcher.metrics.latencies["decode_step"]
    assert stats["tokens_per_s"] == pytest.approx(
        emitted / (pre.total_s + dec.total_s))


def test_impl_and_dtype_pass_through():
    _, cfg, _, tp = _setup("mixtral-8x7b")
    batcher = ContinuousBatcher(cfg, tp, batch_slots=2, max_seq=24,
                                impl="ref", dtype=torch.float32)
    assert batcher.cache["p0"]["k"].dtype == torch.float32
    assert batcher.cache["p0"]["k"].shape[2] == cfg.window   # a ring
    batcher.submit(Request(rid=0, prompt=torch.arange(18), max_new_tokens=4))
    (done,) = batcher.run()
    assert len(done.generated) == 4
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ContinuousBatcher(cfg, tp, batch_slots=1, max_seq=8,
                          impl="cuda")._admit(0, Request(
                              rid=1, prompt=torch.arange(4),
                              max_new_tokens=2))
