"""Continuous-batching serving scheduler (port of
``repro.serving.scheduler``).

Serving keeps the decode batch full: finished sequences free their slot,
queued requests are admitted with an immediate prefill into that slot, and
every decode step advances all active slots together.

A slot table (per-slot position, request), a FIFO admission queue, and step
functions over ``models.lm``'s prefill and decode.  The cache is one fixed
(G, B, S, ...) buffer of ``lm.init_cache``'s layout (sliding-window layers
keep rings of ``min(window, max_seq)`` slots under the default
``perf.windowed_local_cache``); admission writes a request's
prefill cache into its slot (no reallocation: slots are the unit of
elasticity), and a decode step updates it in place.  Each slot keeps its
own position, so the rings of different rows wrap at different steps.
``impl`` and ``dtype`` pass through to ``lm`` as its entry points take
them.  Events ``scheduler.admit``, ``scheduler.complete`` and
``scheduler.evict`` go to ``observability.events`` when a log is installed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..observability import events
from ..observability.metrics import MetricsRegistry


@dataclass
class Request:
    rid: int
    prompt: torch.Tensor         # (T,) int tokens
    max_new_tokens: int
    generated: list = field(default_factory=list)
    done: bool = False


def _place(buf: dict, new: dict, slot: int) -> None:
    """Copy a one-sequence cache into row ``slot`` of the batched cache."""
    for k, v in new.items():
        if isinstance(v, dict):
            _place(buf[k], v, slot)
        else:
            buf[k][:, slot:slot + 1] = v


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int,
                 max_seq: int, impl: str = "auto",
                 dtype=lm.COMPUTE_DTYPE):
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_seq = max_seq
        self.impl, self.dtype = impl, dtype
        self.device = params["embed"]["e"].device
        self.cache = lm.init_cache(cfg, batch_slots, max_seq,
                                   device=self.device, dtype=dtype)
        self.pos = torch.zeros((batch_slots,), dtype=torch.int32,
                               device=self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        # per-batcher telemetry: admission/completion counters + rolling
        # prefill and decode-step latency percentiles
        self.metrics = MetricsRegistry()

    # ------------------------------ admission --------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self, slot: int, req: Request):
        """Prefill the request into its slot's cache region."""
        t0 = time.perf_counter()
        t = req.prompt.shape[0]
        batch = {"tokens": req.prompt[None].to(self.device)}
        logits, cache1 = lm.prefill(self.cfg, self.params, batch,
                                    max_seq=self.max_seq, impl=self.impl,
                                    dtype=self.dtype)
        _place(self.cache, cache1, slot)
        self.pos[slot] = t
        first = int(torch.argmax(logits[0, -1]))
        req.generated.append(first)
        self.slot_req[slot] = req
        self.metrics.counter("requests_admitted").inc()
        self.metrics.counter("prompt_tokens").inc(t)
        # the prefill emits the request's first token; counted apart so
        # stats() can include it in the throughput
        self.metrics.counter("prefill_tokens_emitted").inc()
        self.metrics.latency("prefill").observe(time.perf_counter() - t0)
        if events.enabled():
            events.emit("scheduler.admit", rid=req.rid, slot=slot,
                        prompt_tokens=t, queue_depth=len(self.queue))

    def _fill_free_slots(self):
        for slot in range(self.b):
            if self.slot_req[slot] is None and self.queue:
                self._admit(slot, self.queue.pop(0))

    # -------------------------------- decode ---------------------------------
    def step(self):
        """One batched decode step over all active slots."""
        self._fill_free_slots()
        if all(r is None for r in self.slot_req):
            return False
        t0 = time.perf_counter()
        tokens = torch.tensor(
            [[r.generated[-1] if r else 0] for r in self.slot_req],
            dtype=torch.long, device=self.device)
        batch = {"token": tokens, "pos": self.pos}
        logits, self.cache = lm.decode_step(self.cfg, self.params, batch,
                                            self.cache, impl=self.impl,
                                            dtype=self.dtype)
        nxt = torch.argmax(logits[:, -1], dim=-1).tolist()
        active = torch.tensor([r is not None for r in self.slot_req],
                              device=self.device)
        self.pos = torch.where(active, self.pos + 1, self.pos)
        pos = self.pos.tolist()
        n_active = 0
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            n_active += 1
            req.generated.append(nxt[slot])
            self.metrics.counter("tokens_generated").inc()
            if (len(req.generated) >= req.max_new_tokens
                    or pos[slot] + 1 >= self.max_seq):
                req.done = True
                self.completed.append(req)
                self.slot_req[slot] = None     # slot freed for admission
                self.metrics.counter("requests_completed").inc()
                if events.enabled():
                    events.emit("scheduler.complete", rid=req.rid, slot=slot,
                                tokens=len(req.generated))
                    events.emit("scheduler.evict", rid=req.rid, slot=slot)
        self.metrics.counter("decode_steps").inc()
        self.metrics.counter("active_slot_steps").inc(n_active)
        self.metrics.latency("decode_step").observe(time.perf_counter() - t0)
        return True

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.completed

    def stats(self) -> dict:
        """Counters + latency percentiles snapshot (JSON-serializable)."""
        snap = self.metrics.snapshot()
        dec = self.metrics.latencies.get("decode_step")
        pre = self.metrics.latencies.get("prefill")
        c = snap["counters"]
        # every emitted token: decode steps plus the first token each
        # prefill produces, over the wall time both phases spent
        emitted = (c.get("tokens_generated", 0)
                   + c.get("prefill_tokens_emitted", 0))
        busy_s = ((dec.total_s if dec else 0.0)
                  + (pre.total_s if pre else 0.0))
        if busy_s > 0:
            snap["tokens_per_s"] = emitted / busy_s
        slots = c.get("decode_steps", 0) * self.b
        snap["slot_occupancy"] = (c.get("active_slot_steps", 0) / slots
                                  if slots else 0.0)
        return snap
