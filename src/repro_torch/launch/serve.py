"""Serving launcher: prefill a batch of prompts, then batched greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --smoke --prompt-len 16 --gen 16 --batch 2 --device cpu

The port of ``repro.launch.serve``: random weights from seed 0, random
prompts, one prefill, then ``gen - 1`` decode steps that update the cache
in place; it prints the prefill time, the decode time per token and a
sample; every arch of ``configs.ARCHS`` is served.  On CUDA (the default
device) the attention (prefill and decode) and the depthwise convs (Mamba2's
short conv, RWKV-6's token shift) run through the hand-written kernels.  ``--metrics-port`` serves the loop's
Prometheus metrics (prefill and per-token latencies, prompt and generated
token counts) and ``--event-log`` appends ``serve.prefill`` and
``serve.complete`` events, as ``repro.launch.serve``'s flags do.  ``--mesh
smoke|single|multi`` serves through the sharded prefill and decode steps on
that device mesh (``launch.mesh.mesh_from_flag``; params placed by
``launch.sharding``'s specs); without it nothing is sharded.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

import torch

from ..configs import get_config
from ..models import lm
from ..models.config import ModelConfig
from ..models.convert import resolve_device
from ..models.layers import with_compute_copies
from ..observability import events
from ..observability.metrics import MetricsRegistry
from ..observability.prom import MetricsExporter


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_model(arch: str, *, smoke: bool = False, device="cuda",
               seed: int = 0) -> tuple[ModelConfig, dict]:
    """(config, parameters): random fp32 weights drawn on ``device`` from
    ``seed``, with their bf16 compute copies."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, with_compute_copies(lm.init_params(cfg, gen, device=dev))


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, *,
                 device="cuda", seed: int = 0) -> dict:
    """Random prompt tokens (or frame/patch embeddings for ``embeds`` archs)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.input_mode == "embeds":
        return {"embeds": torch.randn((batch, prompt_len, cfg.d_model),
                                      generator=gen, device=dev
                                      ).to(lm.COMPUTE_DTYPE)}
    return {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                    generator=gen, device=dev)}


def generate(cfg: ModelConfig, params: dict, prompts: dict, gen: int, *,
             impl: str = "auto") -> dict:
    """Prefill, then ``gen - 1`` greedy decode steps.

    Returns ``tokens`` (B, gen), ``prefill_ms`` and ``step_ms`` (host clock,
    each ending in a device synchronise).
    """
    return _generate(
        cfg, prompts, gen,
        lambda p, max_seq: lm.prefill(cfg, params, p, max_seq=max_seq,
                                      impl=impl),
        lambda db, cache: lm.decode_step(cfg, params, db, cache, impl=impl))


def generate_sharded(cfg: ModelConfig, params: dict, prompts: dict, gen: int,
                     mesh, *, impl: str = "auto") -> dict:
    """``generate`` through ``launch.steps``' sharded prefill and decode
    steps on ``mesh``; ``params`` are the fp32 masters (no compute copies),
    placed here.  Returns the same keys, the tokens whole."""
    from .sharding import distribute
    from .steps import make_decode_step, make_prefill
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    b, t = prompts[key].shape[:2]
    dec = make_decode_step(cfg, mesh, t + gen, b, impl=impl)
    pre = make_prefill(cfg, mesh, t + gen, impl=impl)
    params = distribute(params, mesh, dec["param_spec"])

    def whole(out):
        logits, cache = out
        return logits.full_tensor(), cache
    return _generate(cfg, prompts, gen,
                     lambda p, max_seq: whole(pre["fn"](params, p)),
                     lambda db, cache: whole(dec["fn"](params, cache, db)))


def _generate(cfg: ModelConfig, prompts: dict, gen: int, prefill,
              decode) -> dict:
    """The greedy loop of ``generate``: ``prefill(prompts, max_seq)`` and
    ``decode(batch, cache)`` each give (logits, cache)."""
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    b, t = prompts[key].shape[:2]
    dev = prompts[key].device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(prompts, t + gen)
    next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out_tokens, step_ms = [next_tok], []
    emb_gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(gen - 1):
        ts = time.perf_counter()
        db = {"pos": torch.full((b,), t + i, dtype=torch.int32, device=dev)}
        if cfg.input_mode == "embeds":
            db["embeds"] = torch.randn((b, 1, cfg.d_model), generator=emb_gen,
                                       device=dev).to(lm.COMPUTE_DTYPE)
        else:
            db["token"] = next_tok
        logits, cache = decode(db, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        out_tokens.append(next_tok)
    return {"tokens": torch.cat(out_tokens, dim=1), "prefill_ms": prefill_ms,
            "step_ms": step_ms}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--mesh", choices=("smoke", "single", "multi"),
                    default=None, help="serve on this device mesh (default: "
                    "unsharded)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--metrics-port", type=int,
                    default=int(os.environ.get("REPRO_TORCH_METRICS_PORT",
                                               "-1")),
                    help="serve Prometheus /metrics on this port (0 = "
                         "ephemeral, -1 = off; env REPRO_TORCH_METRICS_PORT)")
    ap.add_argument("--event-log",
                    default=os.environ.get("REPRO_TORCH_EVENT_LOG") or None,
                    help="append structured JSONL events to this path "
                         "(env REPRO_TORCH_EVENT_LOG)")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh is not None:
        from .mesh import mesh_from_flag
        mesh = mesh_from_flag(args.mesh,
                              device_type=resolve_device(args.device).type)
        cfg = get_config(args.arch, smoke=args.smoke)
        dev = resolve_device(args.device)
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev)
    else:
        cfg, params = load_model(args.arch, smoke=args.smoke,
                                 device=args.device)
    prompts = make_prompts(cfg, args.batch, args.prompt_len,
                           device=args.device)
    telemetry = MetricsRegistry()
    exporter = None
    if args.event_log:
        events.install(args.event_log)
    try:
        if args.metrics_port >= 0:
            exporter = MetricsExporter({"serve": telemetry},
                                       port=args.metrics_port)
            print(f"metrics: http://127.0.0.1:{exporter.start()}/metrics")
        out = (generate(cfg, params, prompts, args.gen) if mesh is None
               else generate_sharded(cfg, params, prompts, args.gen, mesh))
        steps = out["step_ms"]
        telemetry.latency("prefill").observe(out["prefill_ms"] / 1e3)
        telemetry.counter("prompt_tokens").inc(args.batch * args.prompt_len)
        for ms in steps:
            telemetry.latency("decode_token").observe(ms / 1e3)
        telemetry.counter("tokens_generated").inc(args.batch * args.gen)
        events.emit("serve.prefill", arch=cfg.name, batch=args.batch,
                    prompt_tokens=args.prompt_len, ms=out["prefill_ms"])
        ms = statistics.mean(steps) if steps else 0.0
        events.emit("serve.complete", arch=cfg.name, batch=args.batch,
                    tokens=int(out["tokens"].shape[1]), ms_per_token=ms)
        print(f"prefill {args.prompt_len} tokens x{args.batch}: "
              f"{out['prefill_ms']:.0f} ms")
        print(f"decoded {out['tokens'].shape[1]} tokens/seq @ {ms:.0f} "
              "ms/token")
        lw = telemetry.latency("decode_token")
        if lw.count:
            print(lw.format())
        print("sample:", out["tokens"][0, :12].tolist())
    finally:
        if exporter is not None:
            exporter.stop()
        if args.event_log:
            events.uninstall()
    return telemetry


if __name__ == "__main__":
    main()
