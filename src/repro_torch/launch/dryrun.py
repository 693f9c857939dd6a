"""Dry run: trace every (arch x shape x mesh) cell's sharded step on a fake
mesh, allocating nothing (port of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell runs in this one process on a fake process group
(``torch.testing``'s ``FakeStore``, backend ``"fake"``) of 256 (16x16) or
512 (2x16x16) ranks, as rank 0, under ``FakeTensorMode``: the state, the
batch and the caches are DTensors of fake tensors placed by
``launch.sharding``'s specs, and the step of ``launch.steps`` runs through
the plain versions of the kernels (the device is the CPU).  The record
(``<out>/<arch>__<shape>__<single|multi>.json``) keeps ``repro``'s keys
where they carry over:

  * ``hlo``: device 0's FLOPs, HBM bytes and collective bytes, counted by
    ``launch.graph_analysis`` from the ops the step runs (per-device, local
    shapes; the bytes an upper bound, nothing being fused).
  * ``memory``: ``argument_bytes`` are device 0's shards of the step's
    inputs (state or params, batch, cache), ``output_bytes`` its outputs',
    ``temp_bytes`` the peak of the live tensors the step made (an estimate:
    no allocator, no fusion), ``peak_bytes`` their sum.
  * ``roofline``: those counts over the H100 SXM's published peaks: 989
    TFLOP/s dense bf16, 3.35 TB/s HBM and 450 GB/s of NVLink each way (the
    data sheet).  A 16-wide 'model' axis spans two 8-GPU nodes, whose link
    is slower than NVLink, so the collective term is a lower bound.
  * ``lower_s`` is the trace's time.  ``compile_s`` and XLA's
    ``cost_analysis`` have no counterpart (nothing is compiled).
  * ``perf``: the flags the cell was traced under.

``--perf`` is ``repro``'s: ``off`` (the default, the paper-faithful
baseline), ``on``, or a comma list of flags to turn on from ``off``
(``set_perf``).  ``on`` and ``off`` set the four flags ``bf16_attn_io``,
``rwkv_chunked``, ``bf16_moe_dispatch`` and ``windowed_local_cache`` and
leave the others (``rwkv_chunk``, ``grouped_moe_dispatch``,
``tp_serving_params``) as ``REPRO_PERF`` or the caller set them, as
``repro``'s do.  ``main`` restores the flags when it returns.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from .. import perf

# H100 SXM, NVIDIA's published figures (not measured here)
PEAK_FLOPS = 989e12          # dense bf16, per device
HBM_BW = 3.35e12             # bytes/s per device
NVLINK_BW = 450e9            # bytes/s per device, each way


_MODE_FLAGS = ("bf16_attn_io", "rwkv_chunked", "bf16_moe_dispatch",
               "windowed_local_cache")


def set_perf(mode: str):
    """'off' (paper-faithful baseline), 'on', or comma list of flags."""
    if mode in ("on", "off"):
        perf.set_flags(**{k: mode == "on" for k in _MODE_FLAGS})
    else:
        set_perf("off")
        perf.set_flags(**{k.strip(): True for k in mode.split(",") if k})


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0) for the
    block; no other group may be live."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from ..pytree import leaves
    n = 0
    for x in leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def _fake_batch(structs: dict) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
            structs.items()}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               optimizer: str | None = None, *, smoke: bool = False) -> dict:
    """Trace one cell; returns its record.  ``smoke`` takes the reduced
    config and shape (the meshes stay the production ones)."""
    from ..configs import get_config, get_shape
    from .mesh import make_production_mesh

    cfg = get_config(arch, smoke=smoke)
    shape = get_shape(shape_name, smoke=smoke)
    if optimizer is None:
        optimizer = "adafactor" if cfg.param_count() > 1e11 else "adamw"
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        return _trace_cell(cfg, shape, mesh, optimizer, arch, shape_name,
                           multi_pod)


def _trace_cell(cfg, shape, mesh, optimizer, arch, shape_name, multi_pod):
    from ..models import lm
    from . import steps as steps_mod
    from .graph_analysis import GraphCounter
    from .mesh import mesh_num_devices
    from .sharding import axis_sizes, distribute

    n_dev = mesh_num_devices(mesh)
    with FakeTensorMode():
        batch = _fake_batch(steps_mod.input_specs(cfg, shape))
        batch = distribute(batch, mesh, steps_mod.batch_spec(
            axis_sizes(mesh), batch,
            shape.global_batch if shape.kind == "decode" else None))
        t0 = time.time()
        if shape.kind == "train":
            mk = steps_mod.make_train_step(cfg, optimizer, mesh=mesh,
                                           device="cpu")
            args = (mk["make_init"](0)(), batch)
        elif shape.kind == "prefill":
            mk = steps_mod.make_prefill(cfg, mesh, max_seq=shape.seq_len)
            params = lm.init_params(cfg, torch.Generator(), device="cpu")
            args = (distribute(params, mesh, mk["param_spec"]), batch)
        else:
            mk = steps_mod.make_decode_step(cfg, mesh, max_seq=shape.seq_len,
                                            batch_size=shape.global_batch)
            params = lm.init_params(cfg, torch.Generator(), device="cpu")
            cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="cpu")
            args = (distribute(params, mesh, mk["param_spec"]),
                    distribute(cache, mesh, mk["cache_spec"]), batch)
        arg_bytes = _local_bytes(args)
        with GraphCounter() as counter:
            out = mk["fn"](*args)
        t_lower = time.time() - t0
        out_bytes = _local_bytes(out)
    g = counter.cost

    compute_s = g.flops / PEAK_FLOPS
    memory_s = g.bytes / HBM_BW
    collective_s = g.collective_bytes / NVLINK_BW
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = (6 if shape.kind == "train" else 2) * n_active * tokens
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "n_devices": n_dev, "optimizer": optimizer,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params": cfg.param_count(), "active_params": n_active,
        "lower_s": round(t_lower, 1),
        "perf": dataclasses.asdict(perf.get()),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": g.peak_live_bytes,
            "peak_bytes": arg_bytes + g.peak_live_bytes,
        },
        "hlo": {
            "flops_per_dev": g.flops,
            "bytes_per_dev": g.bytes,
            "collective_bytes_per_dev": g.collective_bytes,
            "collectives": g.collectives,
            "ops_per_dev": g.ops,
        },
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max((("compute", compute_s), ("memory", memory_s),
                             ("collective", collective_s)),
                            key=lambda kv: kv[1])[0],
            "model_flops": mf,
            "hlo_flops_total": g.flops * n_dev,
            "useful_ratio": mf / (g.flops * n_dev) if g.flops else 0.0,
        },
        "notes": "per-device counts of the traced eager step "
                 "(launch.graph_analysis); no compile_s or cost_analysis; "
                 "memory.temp_bytes is the peak of live fake tensors (an "
                 "estimate); roofline from H100 SXM published peaks, the "
                 "collective term a lower bound",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs and shapes on the production "
                         "meshes")
    ap.add_argument("--perf", default="off",
                    help="'off' (paper-faithful baseline), 'on', or a comma "
                         "list of perf flags to enable")
    args = ap.parse_args(argv)
    with perf.flags():
        set_perf(args.perf)
        return _run(args)


def _run(args):
    from ..configs import ARCHS, SHAPES

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures, records = 0, []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                tag = f"{a}__{s}__{'multi' if mp else 'single'}"
                try:
                    rec = lower_cell(a, s, mp, optimizer=args.optimizer,
                                     smoke=args.smoke)
                except Exception as e:  # noqa: BLE001 — report, go on, fail
                    failures += 1
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
                    continue
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                r, m = rec["roofline"], rec["memory"]
                print(f"OK   {tag:60s} trace={rec['lower_s']:6.1f}s "
                      f"peak={m['peak_bytes'] / 2 ** 30:7.2f}GiB/dev "
                      f"dom={r['dominant']:10s} c/m/x="
                      f"{r['compute_s'] * 1e3:.1f}/{r['memory_s'] * 1e3:.1f}/"
                      f"{r['collective_s'] * 1e3:.1f}ms", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    return records


if __name__ == "__main__":
    main()
