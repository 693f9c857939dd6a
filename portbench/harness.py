"""One run of one cell.

Set-up draws the weights and a pool of input images on the device from the
seed, builds the port's forward and warms it up on the cell's own shape.
The window then drives the forward for the stated seconds, one batch at a
time, each ending with its logits on the host.  With ``trace`` the same
forwards run again, timed without and then with the profiler.  Once the
window has closed and the program's state is freed, the plain reference
works out the pool's logits again and every answer is compared.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import check, devtrace, spec
from .archs import work

# What may take the program's place: the program on its default path; its
# bf16 operands; the plain reference with TF32 on (the control).
ENGINES = ("program", "program_bf16", "reference_tf32")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Unset before the port is imported: the cells run its default path, tuner
# off and every §Perf flag on.
DEFAULT_PATH_UNSET = ("REPRO_TORCH_AUTOTUNE", "REPRO_PERF")
REFERENCE_BLOCK = 16          # images a reference call takes at most


class Answers:
    """Host memory for every answer of a window, allocated in set-up.

    The device copies each batch's logits straight into its slot: pinned
    memory, page-locked and already mapped, so the window pays no page
    fault and no second copy for keeping them (a fresh page a copy cost
    the offline cells 1-2 ms a batch).  Should the window answer more than
    set-up reckoned, another block is allocated then, and counted.
    """

    def __init__(self, like: torch.Tensor, capacity: int):
        self.like, self.blocks, self.n, self.grown = like, [], 0, 0
        self._grow(capacity)

    def _grow(self, n: int) -> None:
        self.blocks.append(torch.empty((n, *self.like.shape),
                                       dtype=self.like.dtype,
                                       pin_memory=self.like.is_pinned()))

    def next(self) -> torch.Tensor:
        """The slot of the next answer."""
        capacity = sum(len(blk) for blk in self.blocks)
        if self.n == capacity:
            self._grow(capacity)
            self.grown += 1
            capacity *= 2
        self.n += 1
        last = self.blocks[-1]
        return last[self.n - 1 - (capacity - len(last))]

    def all(self) -> torch.Tensor:
        """(steps, batch, classes), in the order answered."""
        return torch.cat(self.blocks)[:self.n]


@dataclass
class Window:
    answers: Answers
    seconds: float = 0.0
    images: int = 0
    latency_ms: list = field(default_factory=list)
    enqueue_ms: list = field(default_factory=list)


class Runner:
    """The timed step: the forward of one slot of the pool, its logits
    copied to the host.

    On the GPU an image's latency runs from a CUDA event recorded as the
    call starts (the device is idle then, so the event fires at once) to
    one recorded after the logits' copy; the host's clock is too coarse
    for single milliseconds.  ``enqueue_ms`` is the host's time from the
    call to its return, before anything waits for the device.
    """

    def __init__(self, forward, params, slots: list):
        self.forward, self.params, self.slots = forward, params, slots
        self.cuda = slots[0].is_cuda
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
        self.host = None

    def step(self, k: int, out: torch.Tensor | None = None
             ) -> tuple[float, float]:
        """(latency ms, enqueue ms); the logits are copied to ``out``, or
        left in ``host``."""
        if self.cuda:
            self.start.record()
        t0 = time.perf_counter()
        y = self.forward(self.params, self.slots[k])
        t1 = time.perf_counter()
        if self.host is None:
            self.host = torch.empty(y.shape, dtype=y.dtype,
                                    pin_memory=self.cuda)
        (self.host if out is None else out).copy_(y, non_blocking=True)
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            latency = self.start.elapsed_time(self.end)
        else:
            latency = (time.perf_counter() - t0) * 1e3
        return latency, (t1 - t0) * 1e3

    def steps(self, n: int) -> list[float]:
        """n steps; the seconds of each on the host's clock."""
        walls = []
        for i in range(n):
            t = time.perf_counter()
            self.step(i % len(self.slots))
            walls.append(time.perf_counter() - t)
        return walls

    def window(self, seconds: float, batch: int, answers: Answers) -> Window:
        """Steps through the slots in turn until ``seconds`` have passed;
        step i answers slot i % len(slots)."""
        win = Window(answers)
        i, t0 = 0, time.perf_counter()
        deadline = t0 + seconds
        while True:
            lat, enq = self.step(i % len(self.slots), answers.next())
            win.latency_ms.append(lat)
            win.enqueue_ms.append(enq)
            i += 1
            if time.perf_counter() >= deadline:
                break
        win.seconds = time.perf_counter() - t0
        win.images = i * batch
        return win


@dataclass
class Reading:
    """What a per-layer metric's reader reads."""
    cell: spec.Cell
    ops: list                 # archs.work.Op of one forward at the batch
    peak: dict | None         # the card's peaks, None if not in peaks.json
    window: Window
    profile: devtrace.Profile | None

    def mfu_percent(self) -> float | None:
        """Model FLOPs (2 x the multiply-adds of every conv and the fc, from
        the layer table) of the images completed, over the window's seconds,
        as a share of the card's peak for the configuration's dtype."""
        if self.peak is None or not self.window.images:
            return None
        per_image = sum(o.model_flops for o in self.ops) / self.cell.batch
        return (100.0 * per_image * self.window.images / self.window.seconds
                / self.peak["flops_per_s"])

    def roofline_percent(self) -> float | None:
        """The least time the card could take for one forward's work over
        the device's busy time per profiled forward."""
        if self.peak is None or self.profile is None \
                or self.profile.busy_s <= 0:
            return None
        least = work.least_seconds(self.ops, self.peak["flops_per_s"],
                                   self.peak["bytes_per_s"])
        return 100.0 * least / (self.profile.busy_s / self.profile.forwards)

    def idle_percent(self) -> float | None:
        """The share of the profiled forwards' wall with no device op."""
        if self.profile is None or self.profile.wall_s <= 0:
            return None
        return 100.0 * (1.0 - self.profile.busy_s / self.profile.wall_s)


def peaks(kind: str, dtype: str, root: Path = spec.ROOT) -> dict | None:
    table = json.loads((Path(root) / "peaks.json").read_text())
    if kind not in table:
        return None
    return {"flops_per_s": table[kind][f"{dtype}_flops_per_s"],
            "bytes_per_s": table[kind]["bytes_per_s"]}


def _tree(fn, t):
    if isinstance(t, dict):
        return {k: _tree(fn, v) for k, v in t.items()}
    return fn(t)


def _engine(engine: str, c: spec.Cell, params: dict, pool: torch.Tensor):
    """(forward, params, pool) of what takes the program's place."""
    if engine == "program":
        return c.arch().program(c.config), params, pool
    if engine == "program_bf16":
        # weights and images in bf16; folded-BN vectors stay fp32
        return (c.arch().program(c.config),
                _tree(lambda t: t.bfloat16() if t.dim() > 1 else t, params),
                pool.bfloat16())
    if engine == "reference_tf32":
        ref = c.reference()
        return (lambda p, x: ref.forward(c.config, p, x, tf32=True), params,
                pool)
    raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def _quantile(xs: list, q: float) -> float:
    """The q-quantile of xs, interpolated between order statistics (the
    'inclusive' method of Python's statistics.quantiles)."""
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    return s[lo] + (s[min(lo + 1, len(s) - 1)] - s[lo]) * (pos - lo)


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def draw(c: spec.Cell, seed: int, dev: torch.device):
    """(weights, pool of input images) of a cell, from one generator on
    ``dev`` seeded with ``seed``: the same seed gives the same tensors."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = c.arch().draw(c.config, gen, dev)
    size, ch = c.config["image_size"], c.config["in_channels"]
    pool = torch.randn((c.traffic["pool_images"], size, size, ch),
                       generator=gen, device=dev)
    return params, pool


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = spec.ROOT,
             marks: list | None = None, engine: str = "program",
             log=print) -> dict:
    """Run one cell; returns the result line's object (``check`` last).

    ``marks``: (phase, host clock at its end) of the set-up before the
    call, the first at the process's start (set-up counts from there);
    ``log`` takes the earlier lines of the run's record.
    """
    marks = list(marks or [("start", time.perf_counter())])
    c = spec.cell(name, root)
    dev = torch.device(device)
    b = c.batch
    params, pool = draw(c, seed, dev)
    marks.append(("draw", time.perf_counter()))
    forward, run_params, run_pool = _engine(engine, c, params, pool)
    slots = [run_pool[i:i + b] for i in range(0, len(run_pool), b)]
    n_slots = len(slots)
    runner = Runner(forward, run_params, slots)
    warm = runner.steps(c.traffic["warmup_forwards"])
    marks.append(("warmup", time.perf_counter()))
    # room for twice the steps the fastest warm-up step would fit
    answers = Answers(runner.host, 2 * math.ceil(seconds / min(warm)) + 8)
    if runner.cuda:
        torch.cuda.synchronize(dev)
    gc.collect()
    marks.append(("answers", time.perf_counter()))
    setup_s = marks[-1][1] - marks[0][1]

    win = runner.window(seconds, b, answers)

    prof, walls = None, {}
    if trace:
        n = c.traffic["profiled_forwards"]
        t = time.perf_counter()
        runner.steps(n)
        walls = {"profiled_forwards": n,
                 "unprofiled_wall_s": time.perf_counter() - t}
        if runner.cuda:
            devtrace.profile(lambda: runner.steps(2), 2)    # profiler start-up
            prof = devtrace.profile(lambda: runner.steps(n), n)
            walls["profiled_wall_s"] = prof.wall_s if prof else None
    peak_bytes = torch.cuda.max_memory_allocated(dev) if runner.cuda else 0
    kind = torch.cuda.get_device_name(dev) if runner.cuda else "cpu"

    # the program's state goes before the reference runs
    del runner, forward, run_params, run_pool, slots
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = c.reference()
    want = torch.cat([ref.forward(c.config, params, pool[i:i +
                                                         REFERENCE_BLOCK])
                      for i in range(0, len(pool), REFERENCE_BLOCK)]).cpu()
    reference_s = time.perf_counter() - t
    errs = check.image_errors(win.answers.all(), n_slots, want, b)
    limit = float(c.limits["logit_err"])
    logit_err = float(errs.max()) if errs.numel() else math.inf
    failed = int((errs > limit).sum())
    correct = errs.numel() == win.images and failed == 0

    e2e = {"setup_s": setup_s, "images_per_s": win.images / win.seconds,
           "image_ms_p50": _quantile(win.latency_ms, 0.5),
           "image_ms_p90": _quantile(win.latency_ms, 0.9)}
    if trace:
        reading = Reading(c, c.arch().layers(c.config, b),
                          peaks(kind, c.config["dtype"], root), win, prof)
        metrics = {}
        for m in spec.metrics(root):
            value = m.read(reading) if m.reports(c) else None
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {k: {"value": e2e[k], "unit": unit}
                   for k, unit in spec.end_to_end(name, root).items()}

    log(json.dumps({"cell": name, "seed": seed, "engine": engine,
                    "card": _card() if dev.type == "cuda" else "cpu",
                    "window_s": win.seconds, "end_to_end": e2e,
                    "images_compared": int(errs.numel()),
                    "answer_blocks_added_in_window": answers.grown,
                    "latency_ms_deciles": [_quantile(win.latency_ms, q / 10)
                                           for q in range(11)],
                    "enqueue_ms_deciles": [_quantile(win.enqueue_ms, q / 10)
                                           for q in range(11)],
                    "reference_s": reference_s,
                    "setup_phases_s": {k: t - marks[i][1] for i, (k, t)
                                       in enumerate(marks[1:])},
                    "warmup_forwards_s": warm, **walls}))
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": kind, "count": 1, "memory_peak_bytes": peak_bytes}
    result = {"correct": bool(correct), "attempted": win.images,
              "failed": failed, "metrics": metrics, "device": device_rec}
    if trace and prof is not None:
        device_rec["busy_s"] = prof.busy_s
        device_rec["window_s"] = prof.wall_s
        result["breakdown"] = devtrace.breakdown(prof)
    result["check"] = {"logit_err": {"value": logit_err, "limit": limit}}
    return result
