"""End-to-end run: train a ~20M-parameter llama-family model for 300
steps on the full substrate (the sharded train step on a (1, 1) mesh, the
prefetching pipeline, async checkpoints, the supervisor).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e_medium
        [--device cpu] [--steps 300] [--smoke] [--ckpt-dir DIR]

The port's ``examples/train_e2e_medium.py``.  It prints the parameter
count, the loss every 25 steps and the loss drop; a full run (300 steps)
must drop the loss by more than 0.3.  ``--smoke`` trains a 2-layer, 64-wide
model of the same family instead (a few seconds on the CPU).  A run over
an existing checkpoint directory resumes from its latest step.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch.distributed as dist

from ..data import PrefetchIterator, SyntheticTokenDataset, to_device
from ..launch import steps as steps_mod
from ..launch.mesh import mesh_from_flag
from ..launch.sharding import distribute
from ..models.config import ModelConfig
from ..models.convert import resolve_device
from ..runtime import TrainSupervisor

CFG = ModelConfig(
    name="demo-20m", n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=704, vocab=8192, loss_chunk=64,
)
SMOKE = ModelConfig(
    name="demo-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=176, vocab=512, loss_chunk=32,
)
STEPS = 300


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--smoke", action="store_true",
                    help="the 2-layer, 64-wide model")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_medium_ckpt"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SMOKE if args.smoke else CFG
    print(f"params: {cfg.param_count() / 1e6:.1f}M")

    made_group = not dist.is_initialized()
    mesh = mesh_from_flag("smoke", device_type=dev.type)
    try:
        ds = SyntheticTokenDataset(cfg.vocab, seq_len=128, global_batch=8)
        mk = steps_mod.make_train_step(cfg, "adamw", 3e-4, mesh=mesh,
                                       device=dev)
        sup = TrainSupervisor(args.ckpt_dir, ckpt_every=100)
        like = mk["make_init"](0)()
        state, start, idx = sup.restore_or_init(lambda: like, like)
        if start:
            state = distribute(state, mesh, mk["state_spec"])
        it = PrefetchIterator(ds, start_index=idx)
        losses = []

        def step_fn(state, batch):
            state, metrics = mk["fn"](state, to_device(batch, dev))
            metrics["loss"] = float(metrics["loss"])   # waits for the step
            return state, metrics

        def cb(step, metrics, dt):
            losses.append(metrics["loss"])
            if step % 25 == 0:
                print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                      f"{dt * 1e3:.0f} ms", flush=True)

        t0 = time.time()
        try:
            state, last, _ = sup.run(state, step_fn, it, start, args.steps,
                                     cb)
        finally:
            it.close()
        if not losses:
            print(f"nothing to run: the checkpoint is at step {start}")
            return losses
        print(f"\n{last - start} steps in {time.time() - t0:.0f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(drop {losses[0] - losses[-1]:.3f})")
        if args.steps >= STEPS and start == 0:
            if not losses[-1] < losses[0] - 0.3:
                raise SystemExit("training failed to learn")
            print("END-TO-END TRAINING: OK")
        return losses
    finally:
        if made_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
