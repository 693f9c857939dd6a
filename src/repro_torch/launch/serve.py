"""Serving launcher: prefill a batch of prompts, then batched greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --smoke --prompt-len 16 --gen 16 --batch 2 --device cpu

The port of ``repro.launch.serve``: random weights from seed 0, random
prompts, one prefill, then ``gen - 1`` decode steps that update the cache
in place; it prints the prefill time, the decode time per token and a
sample.  On CUDA (the default device) the attention and Mamba2 conv run
through the hand-written kernels.  ``--mesh``, ``--metrics-port`` and
``--event-log`` wait for the distribution and observability ports
(ROADMAP.md).
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..configs import get_config
from ..models import lm
from ..models.config import ModelConfig
from ..models.convert import resolve_device
from ..models.layers import with_compute_copies


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
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    b, t = prompts[key].shape[:2]
    dev = prompts[key].device
    max_seq = t + gen
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, params, prompts, max_seq=max_seq,
                               impl=impl)
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
        logits, cache = lm.decode_step(cfg, params, db, cache, impl=impl)
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    cfg, params = load_model(args.arch, smoke=args.smoke, device=args.device)
    prompts = make_prompts(cfg, args.batch, args.prompt_len,
                           device=args.device)
    out = generate(cfg, params, prompts, args.gen)
    print(f"prefill {args.prompt_len} tokens x{args.batch}: "
          f"{out['prefill_ms']:.0f} ms")
    steps = out["step_ms"]
    ms = statistics.mean(steps) if steps else 0.0
    print(f"decoded {out['tokens'].shape[1]} tokens/seq @ {ms:.0f} ms/token")
    print("sample:", out["tokens"][0, :12].tolist())


if __name__ == "__main__":
    main()
