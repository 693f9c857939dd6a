"""Fault tolerance: checkpoint/restart supervision, preemption handling,
straggler detection (port of ``repro.runtime.fault_tolerance``).

* **Checkpoint/restart**: ``TrainSupervisor`` checkpoints every
  ``ckpt_every`` steps (async drain) and on preemption; a restart resumes
  from the latest complete checkpoint, data cursor included, so the token
  stream is the one an uninterrupted run sees.
* **Preemption**: SIGTERM/SIGINT (or ``request_preemption``) set a flag
  checked once per step; the loop then saves synchronously and returns.
* **Stragglers**: per-step wall times feed an EWMA; a step slower than
  ``straggler_factor`` x the EWMA is recorded (and emitted as an event).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

from .. import checkpoint as ckpt
from ..observability import events


@dataclass
class StragglerDetector:
    alpha: float = 0.1
    straggler_factor: float = 2.0
    ewma: float | None = None
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float, host: int = 0) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.straggler_factor * self.ewma)
        if is_straggler:
            self.events.append({"step": step, "host": host, "dt": dt,
                                "ewma": self.ewma})
            if events.enabled():
                events.emit("fault.straggler", step=step, host=host,
                            dt_s=dt, ewma_s=self.ewma)
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class TrainSupervisor:
    """Wraps a step function with checkpoint/restart + preemption handling."""

    def __init__(self, ckpt_dir: str, ckpt_every: int = 100,
                 install_signal_handlers: bool = False):
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.preempted = False
        self.straggler = StragglerDetector()
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._on_preempt)

    def _on_preempt(self, signum, frame):
        self.preempted = True

    def request_preemption(self):
        """Programmatic preemption (tests simulate node loss with it)."""
        self.preempted = True

    def restore_or_init(self, init_fn, like):
        """Returns (state, start_step, data_index).  ``like`` gives the
        structure (and, for tensor leaves, the device) to restore into."""
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return init_fn(), 0, 0
        state, meta = ckpt.restore(self.ckpt_dir, last, like)
        return state, int(meta.get("step", last)), int(meta.get("data_index", 0))

    def run(self, state, step_fn, batches, start_step: int = 0,
            num_steps: int = 100, metrics_cb=None):
        """Supervised loop.  ``step_fn(state, batch) -> (state, metrics)``.

        ``batches`` is an iterator with a ``.index`` cursor (data/pipeline).
        Returns (state, last_step, interrupted).
        """
        step = start_step
        for _ in range(num_steps - start_step):
            if self.preempted:
                ckpt.save(self.ckpt_dir, step, state,
                          {"step": step, "data_index": batches.index})
                if events.enabled():
                    events.emit("fault.preempt", step=step,
                                data_index=batches.index)
                    events.emit("fault.checkpoint", step=step, sync=True,
                                data_index=batches.index)
                return state, step, True
            t0 = time.perf_counter()
            batch = next(batches)
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            straggled = self.straggler.observe(step, dt)
            if events.enabled():
                events.emit("train.step", step=step, dt_s=dt,
                            straggler=straggled)
            if metrics_cb:
                metrics_cb(step, metrics, dt)
            step += 1
            if step % self.ckpt_every == 0:
                ckpt.save_async(self.ckpt_dir, step, state,
                                {"step": step, "data_index": batches.index})
                if events.enabled():
                    events.emit("fault.checkpoint", step=step, sync=False,
                                data_index=batches.index)
        ckpt.wait_pending()
        return state, step, False
