"""Training launcher: supervised, checkpointed, restartable (port of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu

Random weights from seed 0, ``SyntheticTokenDataset`` batches prefetched and
moved to the device, the train step of ``launch.steps`` under
``runtime.TrainSupervisor`` (async checkpoints every ``--ckpt-every`` steps,
SIGTERM/SIGINT save and stop); a run over an existing checkpoint directory
resumes from its latest step.  It prints the per-step loss and time, the
step-latency summary and tokens/s.  On CUDA (the default device) attention
and the depthwise convs train through the hand-written kernels (their
autograd Functions).  ``--mesh smoke|single|multi`` trains through the
sharded step on that device mesh (``launch.mesh.mesh_from_flag``: smoke is
(1, 1) in one process; single and multi need ``torchrun`` with 256 or 512
processes); without it the step is unsharded.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs import get_config
from ..data import PrefetchIterator, SyntheticTokenDataset, to_device
from ..launch import steps as steps_mod
from ..launch.mesh import mesh_from_flag
from ..launch.sharding import distribute
from ..models.convert import resolve_device
from ..observability import events, trace
from ..observability.export import export_chrome_trace
from ..observability.metrics import MetricsRegistry
from ..observability.prom import MetricsExporter
from ..runtime import TrainSupervisor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--mesh", choices=("smoke", "single", "multi"),
                    default=None, help="train on this device mesh (default: "
                    "unsharded)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"),
                    help="checkpoints; a run over one resumes from its "
                         "newest step (default: under $TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--impl", default="auto", choices=("auto", "cuda", "ref"))
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="activations' dtype (parameters stay fp32)")
    ap.add_argument("--trace-out", default=None,
                    help="export the span trace to this JSON path")
    ap.add_argument("--trace-chrome", default=None,
                    help="export a chrome://tracing / Perfetto trace here")
    ap.add_argument("--metrics-port", type=int,
                    default=int(os.environ.get("REPRO_TORCH_METRICS_PORT",
                                               "-1")),
                    help="serve Prometheus /metrics on this port (0 = "
                         "ephemeral, -1 = off; env REPRO_TORCH_METRICS_PORT)")
    ap.add_argument("--event-log",
                    default=os.environ.get("REPRO_TORCH_EVENT_LOG") or None,
                    help="append structured JSONL events to this path "
                         "(env REPRO_TORCH_EVENT_LOG)")
    return ap


def main(argv=None):
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.trace_out or args.trace_chrome:
        trace.enable()
    if args.event_log:
        events.install(args.event_log)

    cfg = get_config(args.arch, smoke=args.smoke)
    ds = SyntheticTokenDataset(cfg.vocab, args.seq_len, args.batch,
                               input_mode=cfg.input_mode, d_model=cfg.d_model)
    mesh = (None if args.mesh is None
             else mesh_from_flag(args.mesh, device_type=dev.type))
    mk = steps_mod.make_train_step(cfg, args.optimizer, args.lr, mesh=mesh,
                                   impl=args.impl, dtype=DTYPES[args.dtype],
                                   device=dev)
    sup = TrainSupervisor(args.ckpt_dir, ckpt_every=args.ckpt_every,
                          install_signal_handlers=True)
    init = mk["make_init"](0)
    like = init()          # the structure and devices a checkpoint fills
    state, start, data_idx = sup.restore_or_init(lambda: like, like)
    if start:
        if mesh is not None:   # a checkpoint holds whole leaves
            state = distribute(state, mesh, mk["state_spec"])
        print(f"resumed from step {start} (data cursor {data_idx})")
    it = PrefetchIterator(ds, start_index=data_idx)

    def step_fn(state, batch):
        state, metrics = mk["fn"](state, to_device(batch, dev))
        metrics["loss"] = float(metrics["loss"])      # waits for the step
        return state, metrics

    telemetry = MetricsRegistry()
    exporter = None
    try:
        if args.metrics_port >= 0:
            exporter = MetricsExporter({"train": telemetry},
                                       port=args.metrics_port)
            print(f"metrics: http://127.0.0.1:{exporter.start()}/metrics")
        tokens_per_step = args.batch * args.seq_len

        def metrics_cb(step, metrics, dt):
            telemetry.counter("steps").inc()
            telemetry.counter("tokens").inc(tokens_per_step)
            telemetry.latency("train_step").observe(dt)
            telemetry.histogram("train_step_seconds").observe(dt)
            telemetry.gauge("last_loss").set(metrics["loss"])
            if step % 10 == 0 or step < 3:
                print(f"step {step:5d}  loss {metrics['loss']:.4f}  "
                      f"{dt * 1e3:.0f} ms/step", flush=True)

        t0 = time.time()
        state, last, interrupted = sup.run(state, step_fn, it, start,
                                           args.steps, metrics_cb)
        status = "interrupted (checkpointed)" if interrupted else "done"
        print(f"{status} at step {last}; wall {time.time() - t0:.1f}s; "
              f"stragglers observed: {len(sup.straggler.events)}")
        lw = telemetry.latency("train_step")
        if lw.count:
            print(lw.format())
            print(f"throughput {telemetry.counter('tokens').value / lw.total_s:,.0f} tok/s")
        if args.trace_out:
            trace.tracer.export(args.trace_out)
            print(f"trace: {len(trace.tracer.spans)} spans -> {args.trace_out}")
        if args.trace_chrome:
            export_chrome_trace(trace.tracer.spans, args.trace_chrome)
            print(f"chrome trace -> {args.trace_chrome} "
                  "(open in ui.perfetto.dev)")
    finally:
        it.close()
        if exporter is not None:
            exporter.stop()
        if args.event_log:
            log = events.get()
            print(f"event log: {log.emitted if log else 0} events -> "
                  f"{args.event_log}")
            events.uninstall()
    return state


if __name__ == "__main__":
    main()
