"""Port parity: the data pipeline and the runtime (supervisor, straggler
detector, elastic plan) against ``repro``.

Batches must be bit-identical to ``repro``'s; the supervised run resumed
after a preemption must see the uninterrupted run's stream exactly; the
elastic plans must be equal.  No tolerance is needed anywhere.
"""
import json

import numpy as np
import pytest
import torch

from repro.data import PrefetchIterator as JPrefetch
from repro.data import SyntheticTokenDataset as JDataset
from repro.runtime import plan_remesh as j_plan_remesh
from repro_torch.data import PrefetchIterator, SyntheticTokenDataset, to_device
from repro_torch.observability import events
from repro_torch.runtime import (
    StragglerDetector,
    TrainSupervisor,
    largest_pow2_leq,
    plan_remesh,
)


@pytest.mark.parametrize("seed,index,host,hosts", [
    (0, 0, 0, 1), (0, 7, 1, 2), (3, 11, 0, 2), (5, 2, 3, 4), (9, 123, 0, 1)])
@pytest.mark.parametrize("mode", ["tokens", "embeds"])
def test_batches_are_bit_identical_to_repros(seed, index, host, hosts, mode):
    kw = dict(vocab=97, seq_len=200, global_batch=8, seed=seed,
              input_mode=mode, d_model=12)
    want = JDataset(**kw).batch(index, host, hosts)
    got = SyntheticTokenDataset(**kw).batch(index, host, hosts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def test_pipeline_is_deterministic_and_sharded():
    ds = SyntheticTokenDataset(vocab=128, seq_len=32, global_batch=8)
    b1, b2 = ds.batch(7, 0, 2), ds.batch(7, 0, 2)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], ds.batch(7, 1, 2)["tokens"])
    assert b1["tokens"].shape == (4, 32)
    with pytest.raises(ValueError):
        ds.batch(0, 0, 3)


def test_to_device_makes_int64_ids():
    ds = SyntheticTokenDataset(vocab=64, seq_len=16, global_batch=2)
    b = to_device(ds.batch(0), "cpu")
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64
    assert torch.equal(b["tokens"], torch.from_numpy(ds.batch(0)["tokens"]
                                                     ).long())


def test_prefetch_resumes_its_cursor_as_repros():
    ds = SyntheticTokenDataset(vocab=64, seq_len=16, global_batch=4)
    jds = JDataset(vocab=64, seq_len=16, global_batch=4)
    it = PrefetchIterator(ds, start_index=0)
    first = [next(it) for _ in range(3)]
    assert it.index == 3
    it.close()
    it2, jit = PrefetchIterator(ds, start_index=2), JPrefetch(jds, 2)
    again, jagain = next(it2), next(jit)
    it2.close()
    jit.close()
    assert np.array_equal(first[2]["tokens"], again["tokens"])
    assert np.array_equal(again["tokens"], jagain["tokens"])


def test_prefetch_surfaces_a_worker_error(tmp_path):
    class Broken(SyntheticTokenDataset):
        def batch(self, index, host_id=0, num_hosts=1):
            raise KeyError("boom")
    log = tmp_path / "ev.jsonl"
    events.install(str(log))
    try:
        it = PrefetchIterator(Broken(vocab=8, seq_len=4, global_batch=1))
        with pytest.raises(RuntimeError, match="worker failed"):
            next(it)
        it.close()
    finally:
        events.uninstall()
    kinds = [json.loads(line)["kind"] for line in log.read_text().splitlines()]
    assert kinds == ["data.worker_error", "data.closed"]


def test_supervisor_preemption_and_restart(tmp_path):
    """The port of tests/test_train.py's test of the same name: a simulated
    preemption mid-run; the restart resumes the exact stream."""
    ds = SyntheticTokenDataset(vocab=64, seq_len=8, global_batch=2)

    def step_fn(state, batch):
        s = state["sum"] + float(batch["tokens"].sum())
        return {"sum": s, "n": state["n"] + 1}, {}

    sup = TrainSupervisor(str(tmp_path), ckpt_every=2)
    it = PrefetchIterator(ds, start_index=0)
    steps_done = 0

    def cb(step, metrics, dt):
        nonlocal steps_done
        steps_done += 1
        if steps_done == 3:
            sup.request_preemption()

    state, last, interrupted = sup.run({"sum": 0.0, "n": 0}, step_fn, it, 0,
                                       10, cb)
    it.close()
    assert interrupted and last == 3

    sup2 = TrainSupervisor(str(tmp_path), ckpt_every=100)
    state2, start, data_idx = sup2.restore_or_init(lambda: None, state)
    assert (start, data_idx) == (3, 3)
    it2 = PrefetchIterator(ds, start_index=data_idx)
    state2, last2, interrupted2 = sup2.run(state2, step_fn, it2, start, 6)
    it2.close()
    assert not interrupted2 and last2 == 6

    ref = {"sum": 0.0, "n": 0}
    for i in range(6):
        ref, _ = step_fn(ref, ds.batch(i))
    assert ref["sum"] == float(state2["sum"])
    assert int(state2["n"]) == 6


def test_supervisor_restores_tensors_and_emits_events(tmp_path):
    log = tmp_path / "ev.jsonl"
    ds = SyntheticTokenDataset(vocab=16, seq_len=4, global_batch=1)

    def step_fn(state, batch):
        return {"w": state["w"] + 1.0}, {}

    events.install(str(log))
    try:
        sup = TrainSupervisor(str(tmp_path / "ck"), ckpt_every=2)
        it = PrefetchIterator(ds)
        state, last, _ = sup.run({"w": torch.zeros(3)}, step_fn, it, 0, 4)
        it.close()
    finally:
        events.uninstall()
    got, start, data_idx = TrainSupervisor(str(tmp_path / "ck")
                                           ).restore_or_init(None, state)
    assert (start, data_idx) == (4, 4)
    assert torch.equal(got["w"], torch.full((3,), 4.0))
    kinds = [json.loads(line)["kind"] for line in log.read_text().splitlines()]
    assert kinds.count("train.step") == 4
    assert kinds.count("fault.checkpoint") == 2


def test_straggler_detector():
    d = StragglerDetector(alpha=0.5, straggler_factor=2.0)
    for _ in range(5):
        assert not d.observe(0, 1.0)
    assert d.observe(5, 5.0)          # 5x slower than the EWMA
    assert len(d.events) == 1 and d.events[0]["step"] == 5


@pytest.mark.parametrize("old,names,avail", [
    ((16, 16), ("data", "model"), 208), ((2, 16, 16), ("pod", "data", "model"),
                                         300),
    ((8, 4), ("data", "model"), 4), ((4, 2), ("data", "model"), 64)])
def test_plan_remesh_equals_repros(old, names, avail):
    assert plan_remesh(old, names, avail).__dict__ == \
        j_plan_remesh(old, names, avail).__dict__
    assert largest_pow2_leq(avail) <= avail < 2 * largest_pow2_leq(avail)


def test_plan_remesh_keeps_model_groups():
    with pytest.raises(ValueError):
        plan_remesh((4, 16), ("data", "model"), 8)
