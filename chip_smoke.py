"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, the CUDA
toolkit's ``nvcc`` and PyTorch built for CUDA.  It imports only ``torch`` and
``repro_torch`` (from ``src/``), never JAX or the JAX package.  Phases, each
printing one JSON line:

1. device  — fails without CUDA; prints ``nvidia-smi`` name and power limit.
2. build   — compiles every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
             (one process each, in parallel) and lists each kernel's
             registers and spills.
3. shapes  — a traced forward (plain engine) of each CNN records the
             shapes and epilogues the main path gives each kernel.
4. checks  — every CNN kernel against its plain PyTorch version on the card,
             at those shapes and a few ragged ones, fp32 and bf16, every
             epilogue combination.  Tolerance: fp32 2e-4 x sqrt(reduction
             length); bf16 the larger of 2e-2 x sqrt(reduction length) and
             one bf16 step at the largest output, 2^-7 x max|plain| (both
             sides round one fp32 sum to bf16 once, summed in different
             orders, so a value next to a rounding boundary may land on the
             neighbouring bf16 value).
   lm_checks — flash attention, decode attention and conv1d against their
             plain versions at zamba2's shapes and ragged ones (GQA, head
             dims 16, 64, 80, 128, T and S off the tiles, windows,
             soft-caps, a different pos per sequence with 0 and S - 1, FL
             2-4, odd C, strided input), fp32 and bf16.  Tolerance:
             attention fp32 1e-4 (unit-normal inputs, as
             tests/test_kernels.py); bf16 per output element 2^-6 x
             sum_j p_j |v_j| (the plain version on |v| in fp32): p is
             rounded to bf16 on each side and so is the output, four unit
             roundoffs of 2^-8 of that sum at most; conv1d as phase 4 with
             R = FL.
5. times   — each CNN kernel, its plain version and the one PyTorch library
             call (cuDNN conv / cuBLAS GEMM with TF32 off, epilogue not
             included) at the fp32 main-path shapes, and each LM kernel at
             zamba2's bf16 shapes (library: scaled_dot_product_attention,
             causal or with a position mask, and depthwise F.conv1d), with
             CUDA events and a cold L2 cache, beside the bound
             max(FLOPs / peak, bytes / bandwidth).
6. resnet50, resnet50_sparse, vgg16 — the full-width batch-1 224x224 fp32
             forwards through ``models.cnn``; launch counts per forward,
             logits against the same forward with ``impl="ref"`` (tolerance
             1e-3 x max|ref|), median forward time on the host clock, and
             under ``torch.profiler`` the device's busy time per forward.
   zamba2  — serving zamba2-2.7b at full width through
             ``repro_torch.launch.serve``: random weights from seed 0, batch
             4 x 2048-token prompts, 31 greedy decode steps (32 tokens,
             max_seq 2080).  Exact launch counts (per prefill 54 conv1d,
             9 flash, 0 decode; per decode step 9 decode, 0 else), the
             prefill and the first 8 decode steps' logits against the plain
             engine (``impl="ref"``) fed the same tokens, host-clock medians
             of prefill and per-token decode, and the device's busy time and
             idle share of a decode step and a prefill.  Two logit checks,
             per position.  bf16, the main path: within sqrt(2) x the plain
             bf16 engine's distance from the plain engine run in fp32 on
             the same tokens (the random-weight network carries bf16
             rounding differences through 54 layers to a few percent of
             max|logit|, and two bf16 engines with independent rounding
             errors sit about sqrt(2) times their own error apart).  fp32,
             the wiring: the kernel path run with fp32 activations (the
             kernels' fp32 instances) within 1e-3 x max(1, max|ref|) of
             the fp32 plain engine, where rounding no longer hides a wrong
             argument.  Three planted faults (patched in for one run each:
             the decode kernel skips the newest key; one decode
             application per step takes pos + 1; one prefill flash call
             sees half the keys) are measured in both; the fp32 check must
             catch all three.
7. the ``kernels`` line, the card, and the last line
   ``{"ok": true, "device": {...}}``.

Per-case details go to ``chiprun_out/chip_smoke_cases.json``.  Any failed
check raises, so the script exits non-zero and prints no last line.
"""
from __future__ import annotations

import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
# Published peaks (NVIDIA data sheets; dense, no sparsity): fp32 on the CUDA
# cores, bf16 on the tensor cores, device-memory bandwidth.
PEAKS = {"sxm": {"fp32": 67e12, "bf16": 989e12, "bw": 3.35e12},
         "pcie": {"fp32": 51e12, "bf16": 756e12, "bw": 2.0e12}}
FWD_REPS = 20
KERNEL_REPS = 10
PROFILE_REPS = 5
SLEEP_CYCLES = 1_000_000     # ~0.5 ms of device time at H100 clocks
# zamba2-2.7b serving: batch 4 x 2048-token prompts, 32 generated tokens
Z_BATCH, Z_PROMPT, Z_GEN, Z_COMPARE, Z_TIMED = 4, 2048, 32, 8, 3


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def dump(details: dict) -> None:
    """Per-case details, too long for the output, to chiprun_out/."""
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_cases.json").write_text(
        json.dumps(details, indent=1, default=str))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


# ------------------------------------------------------------ helpers ------
def ptxas_summary(lines: list[str]) -> dict:
    """Kernels, most registers and spilled bytes in one source's
    ``-Xptxas -v`` lines (every line goes to the details file)."""
    regs = [int(m) for line in lines
            for m in re.findall(r"Used (\d+) registers", line)]
    spills = [int(m) for line in lines
              for m in re.findall(r"(\d+) bytes spill stores", line)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": sum(spills)}


class Checker:
    """Per-case results of kernel vs plain version, against ``_tol`` or a
    given tolerance (a number, or a tensor of one per element)."""

    def __init__(self):
        self.cases: list[dict] = []

    def add(self, kernel: str, case: dict, got, want, reduction: int,
            tol=None):
        diff = (got.float() - want.float()).abs()
        tol = _tol(want, reduction) if tol is None else tol
        ratio = (diff / tol).max().item()
        ok = ratio <= 1.0 and bool(torch.isfinite(got.float()).all())
        self.cases.append({
            "kernel": kernel, **case, "max_abs_err": diff.max().item(),
            "tol": tol if isinstance(tol, float) else tol.min().item(),
            "err_over_tol": ratio, "ok": ok})

    def failures(self) -> list[dict]:
        return [c for c in self.cases if not c["ok"]]


def _tol(want: torch.Tensor, reduction: int) -> float:
    """The stated tolerance (module docstring, phase 4)."""
    if want.dtype != torch.bfloat16:
        return 2e-4 * reduction ** 0.5
    return max(2e-2 * reduction ** 0.5,
               2.0 ** -7 * want.float().abs().max().item())


def _attn_tol(want: torch.Tensor, plain, args, kw: dict):
    """The stated attention tolerance (module docstring, lm_checks): fp32
    1e-4; bf16 2^-6 x sum_j p_j |v_j| per output element, the plain version's
    answer on |v| in fp32."""
    if want.dtype != torch.bfloat16:
        return 1e-4
    a = [t.float() if t.is_floating_point() else t for t in args]
    a[2] = a[2].abs()                                  # v, or the V cache
    return 2.0 ** -6 * plain(*a, **kw)


def _epilogue_combos():
    """All 16 subsets of (scale, bias, residual, relu)."""
    return list(itertools.product((False, True), repeat=4))


def cold_time_ms(fn, flush: torch.Tensor, reps: int = KERNEL_REPS) -> float:
    """Mean device time of fn() from a cold L2 cache.

    Before each call the stream sleeps (about half a millisecond) and then
    overwrites 64 MB, more than the 50 MB L2.  The host enqueues the events
    and the call while the device still sleeps, so the events time the
    device's work and not the host's launch overhead.
    """
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


# ------------------------------------------------------------- shapes ------
def main_path_shapes(trace, apply, params: dict, x, kw: dict) -> list[dict]:
    """The kernel calls of one forward: kind, shapes, stride/pad, epilogue."""
    with trace.capture() as tr:
        apply(params, x, impl="ref", **kw)
    calls = []
    for sp in tr.find("kernels.conv2d"):
        a = sp.attrs
        calls.append({"kernel": "conv2d", "x": tuple(a["x_shape"]),
                      "w": tuple(a["w_shape"]), "stride": a["stride"],
                      "padding": a["padding"], "epilogue": a["epilogue"]})
    for sp in tr.find("kernels.conv1x1"):
        a = sp.attrs
        kernel = ("mm_weight_stationary"
                  if a["stationarity"] == "weight_stationary"
                  else "mm_act_stationary")
        calls.append({"kernel": kernel, "x": tuple(a["x_shape"]),
                      "w": tuple(a["w_shape"]), "stride": a["stride"],
                      "padding": 0, "epilogue": a["epilogue"]})
    return calls


def ragged_calls() -> list[dict]:
    """Prime channel counts, stride 2, the 7x7 stem pattern, odd rows."""
    return [
        {"kernel": "conv2d", "x": (1, 31, 31, 3), "w": (7, 7, 3, 17),
         "stride": 2, "padding": 3},
        {"kernel": "conv2d", "x": (2, 15, 15, 7), "w": (3, 3, 7, 5),
         "stride": 1, "padding": 1},
        {"kernel": "conv2d", "x": (1, 16, 16, 131), "w": (3, 3, 131, 67),
         "stride": 2, "padding": 1},
        {"kernel": "conv2d", "x": (1, 9, 9, 3), "w": (5, 5, 3, 4),
         "stride": 1, "padding": 2},
        {"kernel": "mm_act_stationary", "x": (513, 129), "w": (129, 257),
         "stride": 1, "padding": 0},
        {"kernel": "mm_act_stationary", "x": (1, 29, 29, 97),
         "w": (97, 131), "stride": 2, "padding": 0},
        {"kernel": "mm_weight_stationary", "x": (97, 193), "w": (193, 89),
         "stride": 1, "padding": 0},
        {"kernel": "mm_weight_stationary", "x": (1, 13, 13, 61),
         "w": (61, 1031), "stride": 2, "padding": 0},
        {"kernel": "mm_weight_stationary", "x": (1, 4099), "w": (4099, 37),
         "stride": 1, "padding": 0},
    ]


# ------------------------------------------------------------ kernels ------
class Kernels:
    """Each kernel's wrapper, plain version, library call, and cost."""

    def __init__(self, conv_mod, mm_mod, peaks: dict):
        self.conv, self.mm, self.peaks = conv_mod, mm_mod, peaks
        self.wrappers = {"conv2d": conv_mod.conv2d,
                         "mm_act_stationary": mm_mod.matmul_act_stationary,
                         "mm_weight_stationary":
                             mm_mod.matmul_weight_stationary}

    def out_shape(self, call):
        if call["kernel"] == "conv2d":
            b, h, w, _ = call["x"]
            fh, fw, _, k = call["w"]
            oh, ow = self.conv.out_hw(h, w, fh, fw, call["stride"],
                                      call["padding"])
            return (b, oh, ow, k)
        k = call["w"][-1]
        if len(call["x"]) == 2:
            return (call["x"][0], k)
        b, h, w, _ = call["x"]
        s = call["stride"]
        return (b, -(-h // s), -(-w // s), k)

    def reduction(self, call) -> int:
        w = call["w"]
        return w[0] * w[1] * w[2] if call["kernel"] == "conv2d" else w[0]

    def run(self, call, x, w, ep):
        fn = self.wrappers[call["kernel"]]
        if call["kernel"] == "conv2d":
            return fn(x, w, stride=call["stride"], padding=call["padding"],
                      **ep)
        return fn(x, w, stride=call["stride"], **ep)

    def plain(self, call, x, w, ep):
        if call["kernel"] == "conv2d":
            return self.conv.conv2d_plain(x, w, stride=call["stride"],
                                          padding=call["padding"], **ep)
        return self.mm.matmul_plain(x, w, stride=call["stride"], **ep)

    def library(self, call, x, w):
        """The one PyTorch call for the same product (no epilogue)."""
        if call["kernel"] == "conv2d":
            wl = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            xl = x.permute(0, 3, 1, 2)          # NHWC memory: channels_last
            return lambda: F.conv2d(xl, wl, stride=call["stride"],
                                    padding=call["padding"])
        if x.ndim == 2:
            return lambda: torch.matmul(x, w)
        wl = w.t().contiguous()[:, :, None, None]
        xl = x.permute(0, 3, 1, 2)
        return lambda: F.conv2d(xl, wl, stride=call["stride"])

    def cost(self, call, dtype) -> tuple[float, float]:
        """(FLOPs, bytes): each input read once, each output written once."""
        es = torch.tensor([], dtype=dtype).element_size()
        m_k = math.prod(self.out_shape(call))
        k = call["w"][-1]
        flops = 2 * m_k * self.reduction(call)
        # a strided 1x1 reads only its subsampled rows
        x_el = (math.prod(call["x"]) if call["kernel"] == "conv2d"
                else m_k // k * call["w"][0])
        ep = call.get("epilogue", "none")
        nbytes = (x_el + math.prod(call["w"]) + m_k) * es
        nbytes += 4 * k * (("scale" in ep) + ("bias" in ep))
        nbytes += m_k * es * ("residual" in ep)
        return flops, nbytes

    def bound_ms(self, call, dtype) -> tuple[float, str]:
        flops, nbytes = self.cost(call, dtype)
        peak = self.peaks["bf16" if dtype == torch.bfloat16 else "fp32"]
        t_ops, t_bytes = flops / peak, nbytes / self.peaks["bw"]
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def make_operands(kern: Kernels, call, dtype, gen):
    dev = "cuda"
    rn = lambda *s: torch.randn(s, device=dev, generator=gen)
    x = rn(*call["x"]).to(dtype)
    w = rn(*call["w"]).to(dtype)
    k = call["w"][-1]
    full = {"scale": 1.0 + 0.2 * rn(k), "bias": 0.3 * rn(k),
            "residual": rn(*kern.out_shape(call)).to(dtype), "relu": True}
    return x, w, full


def epilogue_of(full: dict, scale, bias, residual, relu) -> dict:
    return {"scale": full["scale"] if scale else None,
            "bias": full["bias"] if bias else None,
            "residual": full["residual"] if residual else None,
            "relu": relu}


def model_epilogue(full: dict, tag: str) -> dict:
    return epilogue_of(full, "scale" in tag, "bias" in tag,
                       "residual" in tag, "relu" in tag)


# ------------------------------------------------------------- models ------
def randomize_bn(params: dict, gen: torch.Generator) -> None:
    """Non-trivial folded BN, so the fused epilogue changes the math."""
    for key, v in params.items():
        if isinstance(v, dict) and "scale" in v:
            n = v["scale"].shape[0]
            v["scale"] = (0.5 + torch.rand(n, generator=gen)).to(
                v["scale"].device)
            v["bias"] = (torch.rand(n, generator=gen) - 0.5).to(
                v["bias"].device)
        elif isinstance(v, dict):
            randomize_bn(v, gen)


def profile_busy(fn, reps: int = PROFILE_REPS) -> dict:
    """Device busy time per call of fn under torch.profiler, and the top
    kernels.

    Busy time is the union of the device activity intervals; the idle share
    is the rest of the profiled window (the profiler slows the host, so the
    share is an upper bound for an unprofiled run).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_busy_ms": "not measured"}
    busy, end, by_name = 0.0, -1.0, {}
    for s, e, n in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy / 1e3 / reps,
            "profiled_wall_ms": wall_ms / reps,
            "idle_share": 1.0 - busy / 1e3 / wall_ms,
            "top_device_ms": {n[:80]: t for n, t in top}}


def host_profile(fn, reps: int = PROFILE_REPS) -> dict:
    """Where the host's time per call of fn goes: cProfile, top functions.

    Host microseconds per call by own time (``tottime``); cProfile adds its
    own cost to every Python call, so read the ranking, not the sum.
    """
    import cProfile
    import pstats
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, nc, f"{Path(fn).name}:{line}:{name}")
                   for (fn, line, name), (_, nc, tt, _, _) in stats.items()),
                  reverse=True)[:15]
    total = sum(v[2] for v in stats.values())
    return {"profiled_us_per_call": total / reps * 1e6,
            "top_tottime_us_per_call": {
                where: round(tt / reps * 1e6, 1) for tt, _, where in rows},
            "calls_per_call": {where: nc // reps for _, nc, where in rows}}


def run_model(name, apply, params, x, counters, expected, **kw) -> dict:
    """One counted forward, parity against the plain engine, median time."""
    for fn in counters.values():
        fn.launches = 0
    logits = apply(params, x, **kw)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ref = apply(params, x, impl="ref", **kw)
    torch.cuda.synchronize()
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = 1e-3 * scale
    times = []
    for _ in range(FWD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply(params, x, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec = {"phase": name, "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "max_abs_err_vs_ref": err, "tol": tol, "max_abs_ref": scale,
           "launches": launches, "expected_launches": expected,
           "median_ms": statistics.median(times), "min_ms": min(times),
           **profile_busy(lambda: apply(params, x, **kw))}
    emit(rec)
    if launches != expected:
        raise SystemExit(f"{name}: launches {launches} != {expected}")
    if not (rec["finite"] and err <= tol):
        raise SystemExit(f"{name}: logits off the plain engine by {err} "
                         f"(tol {tol})")
    return rec


# --------------------------------------------------------- LM kernels ------
def lm_kernel_cases() -> list[dict]:
    """zamba2's main-path shapes first (one per kernel), then ragged ones."""
    fa = lambda b, t, h, kh, dh, window=0, softcap=0.0: dict(
        kernel="flash_attention", b=b, t=t, h=h, kh=kh, dh=dh, window=window,
        softcap=softcap)
    da = lambda b, s, h, kh, dh, pos: dict(
        kernel="decode_attention", b=b, s=s, h=h, kh=kh, dh=dh, pos=pos)
    c1 = lambda b, t, c, fl, row=None, col0=0: dict(
        kernel="conv1d_causal", b=b, t=t, c=c, fl=fl, row=row or c, col0=col0)
    return [
        # zamba2: 32 heads of 80, T = 2048; the cache holds 2080 rows; the
        # conv reads the xBC column slice [5120, 10368) of in_proj's output
        fa(Z_BATCH, Z_PROMPT, 32, 32, 80),
        da(Z_BATCH, Z_PROMPT + Z_GEN, 32, 32, 80, (0, 2079, 1000, 2047)),
        c1(Z_BATCH, Z_PROMPT, 5248, 4, row=10368, col0=5120),
        # ragged: GQA, head dims, T off the 64-row tiles, window, soft-cap
        fa(2, 300, 8, 2, 64), fa(1, 257, 4, 4, 128), fa(2, 200, 4, 2, 64, 64),
        fa(1, 130, 6, 3, 80, softcap=50.0), fa(1, 333, 8, 4, 80, 100, 30.0),
        fa(1, 65, 2, 1, 16),
        # a different pos per sequence, 0 and S - 1, S off the 128-row chunks
        da(3, 300, 8, 2, 64, (299, 0, 130)), da(2, 129, 4, 4, 128, (128, 64)),
        da(2, 1000, 6, 3, 80, (999, 511)), da(2, 77, 8, 2, 16, (76, 3)),
        # FL 2-4, odd C (one channel a thread), contiguous and strided x
        c1(Z_BATCH, Z_PROMPT, 5248, 4), c1(2, 33, 131, 3), c1(1, 17, 96, 2),
        c1(3, 100, 1000, 4), c1(2, 40, 64, 2, row=80, col0=8),
    ]


def lm_operands(case: dict, dtype, gen, pos=None):
    """(args, kwargs) of the wrapper for one case, drawn on the card."""
    rn = lambda *s: torch.randn(s, device=DEVICE, generator=gen)
    if case["kernel"] == "flash_attention":
        b, t, h, kh, dh = (case[k] for k in ("b", "t", "h", "kh", "dh"))
        args = (rn(b, t, h, dh), rn(b, t, kh, dh), rn(b, t, kh, dh))
        return (tuple(a.to(dtype) for a in args),
                {"window": case["window"], "softcap": case["softcap"]})
    if case["kernel"] == "decode_attention":
        b, s, h, kh, dh = (case[k] for k in ("b", "s", "h", "kh", "dh"))
        args = (rn(b, h, dh), rn(b, s, kh, dh), rn(b, s, kh, dh))
        p = torch.tensor(pos or case["pos"], dtype=torch.int32, device=DEVICE)
        return tuple(a.to(dtype) for a in args) + (p,), {}
    b, t, c, fl = (case[k] for k in ("b", "t", "c", "fl"))
    full = rn(b, t, case["row"]).to(dtype)
    return (full[..., case["col0"]:case["col0"] + c], rn(fl, c)), {}


def lm_cost(case: dict, dtype, pos) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: each input read once, each output written
    once; attention counts only the (query, key) pairs its mask lets in."""
    es = torch.tensor([], dtype=dtype).element_size()
    if case["kernel"] == "flash_attention":
        t, w = case["t"], case["window"]
        pairs = sum(min(i + 1, w) if w > 0 else i + 1 for i in range(t))
        flops = 4 * case["b"] * case["h"] * case["dh"] * pairs
        nbytes = 2 * case["b"] * t * (case["h"] + case["kh"]) * case["dh"] * es
        return flops, nbytes
    if case["kernel"] == "decode_attention":
        rows = sum(p + 1 for p in pos)
        flops = 4 * case["h"] * case["dh"] * rows
        nbytes = (2 * case["b"] * case["h"] * case["dh"]
                  + 2 * rows * case["kh"] * case["dh"]) * es + 4 * case["b"]
        return flops, nbytes
    n = case["b"] * case["t"] * case["c"]
    return 2 * n * case["fl"], 2 * n * es + 4 * case["fl"] * case["c"]


def lm_library(case: dict, args):
    """The one PyTorch call for the same function (a yardstick only)."""
    if case["kernel"] == "flash_attention":
        q, k, v = (a.transpose(1, 2) for a in args)          # (B, H, T, dh)
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
    if case["kernel"] == "decode_attention":
        q, ck, cv, pos = args
        q4 = q[:, :, None, :]
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
        mask = (torch.arange(ck.shape[1], device=DEVICE)[None, :]
                <= pos[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q4, kt, vt,
                                                      attn_mask=mask,
                                                      enable_gqa=True)
    x, w = args
    xt = x.transpose(1, 2)                                    # (B, C, T) view
    wt = w.t().contiguous()[:, None, :].to(x.dtype)           # (C, 1, FL)
    return lambda: F.conv1d(xt, wt, padding=case["fl"] - 1,
                            groups=case["c"])


def lm_reduction(case: dict) -> int:
    return case["fl"] if case["kernel"] == "conv1d_causal" else case["dh"]


def check_lm_kernels(chk: Checker, lm_kernels: dict, gen) -> dict:
    """Every LM case, fp32 and bf16, against the plain version."""
    for case in lm_kernel_cases():
        wrapper, plain = lm_kernels[case["kernel"]]
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = lm_operands(case, dtype, gen)
            got, want = wrapper(*args, **kw), plain(*args, **kw)
            tol = (None if case["kernel"] == "conv1d_causal"
                   else _attn_tol(want, plain, args, kw))
            chk.add(case["kernel"], {**case, "dtype": str(dtype)[6:]}, got,
                    want, lm_reduction(case), tol)
    torch.cuda.synchronize()
    summary = {}
    for kname in lm_kernels:
        cs = [c for c in chk.cases if c["kernel"] == kname]
        summary[kname] = {
            "cases": len(cs), "failed": sum(not c["ok"] for c in cs),
            "max_err_over_tol": max(c["err_over_tol"] for c in cs),
            **{f"max_abs_err_{d}": max(c["max_abs_err"] for c in cs
                                       if c["dtype"] == d)
               for d in ("float32", "bfloat16")}}
    return summary


def time_lm_kernels(lm_kernels: dict, peaks: dict, flush, gen) -> dict:
    """Each LM kernel at its zamba2 main-path shape, bf16, cold L2.  The
    decode call reads the whole cache (pos = S - 1 for every sequence)."""
    rows = {}
    dtype = torch.bfloat16
    for case in lm_kernel_cases()[:3]:
        kname = case["kernel"]
        wrapper, plain = lm_kernels[kname]
        pos = None
        if kname == "decode_attention":
            pos = (case["s"] - 1,) * case["b"]
        args, kw = lm_operands(case, dtype, gen, pos)
        err = (wrapper(*args, **kw).float()
               - plain(*args, **kw).float()).abs().max().item()
        flops, nbytes = lm_cost(case, dtype, pos or ())
        t_ops, t_bytes = flops / peaks["bf16"], nbytes / peaks["bw"]
        rows[kname] = {
            "case": {**case, "pos": list(pos)} if pos else case,
            "dtype": "bfloat16", "max_abs_err": err,
            "flops": flops, "bytes": nbytes,
            "ms": cold_time_ms(lambda: wrapper(*args, **kw), flush),
            "plain_ms": cold_time_ms(lambda: plain(*args, **kw), flush),
            "library_ms": cold_time_ms(lm_library(case, args), flush),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return rows


# ------------------------------------------------------------- zamba2 ------
def forced_logits(lm, cfg, params, prompts, tokens, *, impl="auto",
                  dtype=None) -> list:
    """fp32 logits (B, V) of the prefill's last position and of one decode
    step per column of ``tokens`` (B, n), each step fed that column (teacher
    forcing), so two engines meet the same inputs whatever their argmax."""
    dtype = dtype or lm.COMPUTE_DTYPE
    b, t = tokens.shape[0], prompts["tokens"].shape[1]
    logits, cache = lm.prefill(cfg, params, prompts, t + Z_GEN, impl=impl,
                               dtype=dtype)
    out = [logits[:, -1].float()]
    for i in range(tokens.shape[1]):
        step = {"token": tokens[:, i:i + 1],
                "pos": torch.full((b,), t + i, dtype=torch.int32,
                                  device=DEVICE)}
        logits, cache = lm.decode_step(cfg, params, step, cache, impl=impl,
                                       dtype=dtype)
        out.append(logits[:, -1].float())
    return out


def planted_faults(attn_mod, fa_mod, da_mod, n_groups: int) -> dict:
    """Wrong paths the logit check must tell from the right one, each a
    patch of a name the model looks up at call time: name -> (module,
    attribute, replacement).  A kernel is replaced by swapping the kernel
    module ``models.attention`` sees for a stand-in, so the wrappers and
    their launch counters stay as they are."""
    real_fa, real_da = fa_mod.flash_attention, da_mod.decode_attention
    real_ad = attn_mod.attention_decode
    ns = types.SimpleNamespace

    def nth(fn, faulty, period):
        calls = [0]

        def wrapped(*a, **kw):
            calls[0] += 1
            return faulty(*a, **kw) if calls[0] % period == 1 else fn(*a, **kw)
        return wrapped

    def flash_half_window(q, k, v, **kw):
        return real_fa(q, k, v, **{**kw, "window": q.shape[1] // 2})

    def decode_pos_plus_1(params, x, ck, cv, pos, **kw):
        return real_ad(params, x, ck, cv, pos + 1, **kw)

    return {
        # the decode kernel leaves out the newest key (this token's own)
        "decode_skips_newest_key": (
            attn_mod, "_decode",
            ns(decode_attention=lambda q, ck, cv, pos: real_da(q, ck, cv,
                                                               pos - 1),
               decode_attention_plain=da_mod.decode_attention_plain)),
        # one shared-attention application per decode step (the first)
        # takes pos + 1: RoPE one step on and the k/v one slot late
        "one_decode_application_pos_plus_1": (
            attn_mod, "attention_decode",
            nth(real_ad, decode_pos_plus_1, n_groups)),
        # the first flash call of the prefill sees only the newest T/2 keys
        "one_prefill_flash_half_window": (
            attn_mod, "_flash",
            ns(flash_attention=nth(real_fa, flash_half_window, n_groups),
               flash_attention_plain=fa_mod.flash_attention_plain)),
    }


def run_zamba2(serve, lm, attn_mod, fa_mod, da_mod, counters: dict) -> dict:
    """Serve zamba2-2.7b at full width: counted launches, parity against
    the plain engine, planted faults, host-clock times, device busy share."""
    t0 = time.perf_counter()
    cfg, params = serve.load_model("zamba2-2.7b", device=DEVICE, seed=SEED)
    prompts = serve.make_prompts(cfg, Z_BATCH, Z_PROMPT, device=DEVICE,
                                 seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    max_seq = Z_PROMPT + Z_GEN

    def counted(fn):
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items()}

    n_groups = cfg.n_groups
    zero = {k: 0 for k in counters}
    want_prefill = {**zero, "conv1d_causal": cfg.n_layers,
                    "flash_attention": n_groups}
    want_step = {**zero, "decode_attention": n_groups}
    want_run = {k: want_prefill[k] + (Z_GEN - 1) * want_step[k]
                for k in counters}

    # the main path, as a user runs it: prompts in, Z_GEN tokens out
    out, launches = counted(lambda: serve.generate(cfg, params, prompts,
                                                   Z_GEN))
    (logits, cache), per_prefill = counted(
        lambda: lm.prefill(cfg, params, prompts, max_seq=max_seq))
    step_batch = {"token": torch.argmax(logits[:, -1], dim=-1)[:, None],
                  "pos": torch.full((Z_BATCH,), Z_PROMPT, dtype=torch.int32,
                                    device=DEVICE)}
    _, per_step = counted(lambda: lm.decode_step(cfg, params, step_batch,
                                                 cache))
    runs = [serve.generate(cfg, params, prompts, Z_GEN)
            for _ in range(Z_TIMED)]

    # parity: every engine fed the main run's own tokens (teacher forcing)
    forced = out["tokens"][:, :Z_COMPARE]
    run = lambda **kw: forced_logits(lm, cfg, params, prompts, forced, **kw)
    bf16, fp32 = lm.COMPUTE_DTYPE, torch.float32
    got, ref = run(), run(impl="ref")
    got32, ref32 = run(dtype=fp32), run(impl="ref", dtype=fp32)
    dist = lambda a, b: [(x - y).abs().max().item() for x, y in zip(a, b)]
    errs, noise, errs32 = dist(got, ref), dist(ref, ref32), dist(got32, ref32)
    tols = {bf16: [2 ** 0.5 * n for n in noise],
            fp32: [1e-3 * max(1.0, r.abs().max().item()) for r in ref32]}
    refs = {bf16: ref, fp32: ref32}
    over = lambda es, ts: max(e / t for e, t in zip(es, ts))
    agree = [(g.argmax(-1) == r.argmax(-1)).float().mean().item()
             for g, r in zip(got, ref)]
    finite = all(bool(torch.isfinite(g).all()) for g in got + got32)
    faults = {}
    for dtype in (bf16, fp32):
        for fname, (mod, attr, fn) in planted_faults(
                attn_mod, fa_mod, da_mod, n_groups).items():
            with mock.patch.object(mod, attr, fn):
                fe = dist(run(dtype=dtype), refs[dtype])
            faults.setdefault(fname, {})[str(dtype)[6:]] = {
                "max_abs_err": fe, "max_err_over_tol": over(fe, tols[dtype])}

    rec = {"phase": "zamba2", "arch": cfg.name, "params": cfg.param_count(),
           "batch": Z_BATCH, "prompt_len": Z_PROMPT, "gen": Z_GEN,
           "setup_s": setup_s, "tokens_shape": list(out["tokens"].shape),
           "launches": launches, "expected_launches": want_run,
           "launches_per_prefill": per_prefill,
           "launches_per_decode_step": per_step,
           "prefill_ms_median": statistics.median(r["prefill_ms"]
                                                  for r in runs),
           "prefill_ms_all": [r["prefill_ms"] for r in runs],
           "decode_ms_per_token_median": statistics.median(
               t for r in runs for t in r["step_ms"]),
           "decode_ms_per_token_min": min(t for r in runs
                                          for t in r["step_ms"]),
           "logits_max_abs_err": errs, "logits_tol": tols[bf16],
           "max_err_over_tol": over(errs, tols[bf16]),
           "logits_max_abs_ref": [r.abs().max().item() for r in ref],
           "plain_bf16_vs_fp32": noise,
           "kernels_bf16_vs_fp32": dist(got, ref32),
           "fp32_logits_max_abs_err": errs32, "fp32_logits_tol": tols[fp32],
           "fp32_max_err_over_tol": over(errs32, tols[fp32]),
           "planted_faults": faults,
           "argmax_agreement": agree, "finite": finite,
           "sample": out["tokens"][0, :12].tolist(),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "decode_step_device": profile_busy(
               lambda: lm.decode_step(cfg, params, step_batch, cache)),
           "decode_step_host": host_profile(
               lambda: lm.decode_step(cfg, params, step_batch, cache), 3),
           "prefill_device": profile_busy(
               lambda: lm.prefill(cfg, params, prompts, max_seq=max_seq),
               reps=1)}
    emit(rec)
    for name, got_n, want_n in (("per prefill", per_prefill, want_prefill),
                                ("per decode step", per_step, want_step),
                                ("per run", launches, want_run)):
        if got_n != want_n:
            raise SystemExit(f"zamba2: launches {name} {got_n} != {want_n}")
    if not finite or rec["max_err_over_tol"] > 1.0 or \
            rec["fp32_max_err_over_tol"] > 1.0:
        raise SystemExit(f"zamba2: logits off the plain engine by {errs} "
                         f"in bf16, {errs32} in fp32 (tol {tols})")
    missed = [f for f, r in faults.items()
              if r["float32"]["max_err_over_tol"] <= 1.0]
    if missed:
        raise SystemExit(f"zamba2: the fp32 logit check misses planted "
                         f"faults {missed}")
    return rec


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/ "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import _build, conv2d as conv_mod
    from repro_torch.kernels import conv1d as c1_mod
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import cnn, lm
    from repro_torch.observability import trace

    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "PCIe" in name or "PCIe" in smi else "sxm"]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks": peaks})
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    nvcc_s = _build.build_all()
    ptxas = {src.stem: [line.strip()
                        for line in _build.build_log(src.stem).splitlines()
                        if "registers" in line or "spill" in line]
             for src in _build.sources()}
    emit({"phase": "build", "nvcc_seconds": nvcc_s,
          "seconds": time.perf_counter() - t0,
          "ptxas": {n: ptxas_summary(lines) for n, lines in ptxas.items()}})

    # 3. main-path shapes (plain engine, traced: no kernel launch)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((1, 224, 224, 3), generator=gen).cuda()
    r50 = cnn.resnet50_init(torch.Generator().manual_seed(SEED))
    randomize_bn(r50, gen)
    vgg = cnn.vgg16_init(torch.Generator().manual_seed(SEED + 1))
    paths = {
        "resnet50": dict(apply=cnn.resnet50_apply, params=r50, kw={}),
        "resnet50_sparse": dict(apply=cnn.resnet50_apply, params=r50,
                                kw={"sparse": True}),
        "vgg16": dict(apply=cnn.vgg16_apply, params=vgg, kw={}),
    }
    calls = {p: main_path_shapes(trace, d["apply"], d["params"], x, d["kw"])
             for p, d in paths.items()}
    emit({"phase": "shapes", **{p: len(c) for p, c in calls.items()}})

    # 4. checks
    kern = Kernels(conv_mod, mm_mod, peaks)
    chk = Checker()
    dgen = torch.Generator(device="cuda").manual_seed(SEED)
    unique = {}
    for p, cs in calls.items():
        for c in cs:
            unique.setdefault((c["kernel"], c["x"], c["w"], c["stride"],
                               c["padding"]), c)
    t0 = time.perf_counter()
    for c in list(unique.values()) + ragged_calls():
        for dtype in (torch.float32, torch.bfloat16):
            x_, w_, full = make_operands(kern, c, dtype, dgen)
            for combo in _epilogue_combos():
                ep = epilogue_of(full, *combo)
                got = kern.run(c, x_, w_, ep)
                want = kern.plain(c, x_, w_, ep)
                chk.add(c["kernel"], {"x": c["x"], "w": c["w"],
                                      "stride": c["stride"],
                                      "padding": c["padding"],
                                      "dtype": str(dtype)[6:],
                                      "epilogue": combo}, got, want,
                        kern.reduction(c))
    torch.cuda.synchronize()
    summary = {}
    for kname in kern.wrappers:
        cs = [c for c in chk.cases if c["kernel"] == kname]
        summary[kname] = {
            "cases": len(cs), "failed": sum(not c["ok"] for c in cs),
            "max_err_over_tol": max(c["err_over_tol"] for c in cs),
            "max_abs_err_fp32": max(c["max_abs_err"] for c in cs
                                    if c["dtype"] == "float32"),
            "max_abs_err_bf16": max(c["max_abs_err"] for c in cs
                                    if c["dtype"] == "bfloat16")}
    emit({"phase": "checks", "seconds": time.perf_counter() - t0,
          "tolerance": "fp32 2e-4 x sqrt(R); bf16 max(2e-2 x sqrt(R), "
                       "2^-7 x max|plain|)",
          **summary})
    lm_kernels = {
        "flash_attention": (fa_mod.flash_attention,
                            fa_mod.flash_attention_plain),
        "decode_attention": (da_mod.decode_attention,
                             da_mod.decode_attention_plain),
        "conv1d_causal": (c1_mod.conv1d_causal, c1_mod.conv1d_causal_plain)}
    t0 = time.perf_counter()
    emit({"phase": "lm_checks",
          **check_lm_kernels(chk, lm_kernels, dgen),
          "seconds": time.perf_counter() - t0,
          "tolerance": "attention fp32 1e-4, bf16 2^-6 x sum_j p_j |v_j| "
                       "per element; conv1d as checks with R = FL"})
    details = {"nvidia_smi": smi, "ptxas": ptxas, "checks": chk.cases}
    if chk.failures():
        dump(details)
        raise SystemExit(f"{len(chk.failures())} kernel checks failed, "
                         f"first: {chk.failures()[0]}")

    # 5. times at the fp32 main-path shapes, with each call's own epilogue
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    per_path = {}
    for p, cs in calls.items():
        rows = []
        for c in cs:
            x_, w_, full = make_operands(kern, c, torch.float32, dgen)
            ep = model_epilogue(full, c["epilogue"])
            got = kern.run(c, x_, w_, ep)
            want = kern.plain(c, x_, w_, ep)
            err = (got - want).abs().max().item()
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                lib_ms = cold_time_ms(kern.library(c, x_, w_), flush)
            bound, by = kern.bound_ms(c, torch.float32)
            flops, nbytes = kern.cost(c, torch.float32)
            rows.append({
                "kernel": c["kernel"], "x": c["x"], "w": c["w"],
                "stride": c["stride"], "epilogue": c["epilogue"],
                "max_abs_err": err, "flops": flops, "bytes": nbytes,
                "ms": cold_time_ms(lambda: kern.run(c, x_, w_, ep), flush),
                "plain_ms": cold_time_ms(lambda: kern.plain(c, x_, w_, ep),
                                         flush),
                "library_ms": lib_ms, "bound_ms": bound, "bound_by": by})
        per_path[p] = rows
        totals = {}
        for kname in kern.wrappers:
            rs = [r for r in rows if r["kernel"] == kname]
            if rs:
                totals[kname] = {
                    "calls": len(rs),
                    **{key: sum(r[key] for r in rs)
                       for key in ("ms", "plain_ms", "library_ms",
                                   "bound_ms")}}
        emit({"phase": "times", "path": p, "per_forward": totals})
    lm_times = time_lm_kernels(lm_kernels, peaks, flush, dgen)
    emit({"phase": "times", "path": "zamba2 kernels, bf16, one call each",
          **{k: {f: r[f] for f in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "max_abs_err")}
             for k, r in lm_times.items()}})

    # 6. the main path, through the entry points a user calls
    counters = {"conv2d": conv_mod.conv2d,
                "mm_act_stationary": mm_mod.matmul_act_stationary,
                "mm_weight_stationary": mm_mod.matmul_weight_stationary,
                **{k: fns[0] for k, fns in lm_kernels.items()}}
    no_lm = {k: 0 for k in lm_kernels}
    expect_r50 = {"conv2d": 17, "mm_act_stationary": 29,
                  "mm_weight_stationary": 7, **no_lm}
    models = {
        "resnet50": run_model("resnet50", cnn.resnet50_apply, r50, x,
                              counters, expect_r50),
        "resnet50_sparse": run_model("resnet50_sparse", cnn.resnet50_apply,
                                     r50, x, counters, expect_r50,
                                     sparse=True),
        "vgg16": run_model("vgg16", cnn.vgg16_apply, vgg, x, counters,
                           {"conv2d": 13, "mm_act_stationary": 0,
                            "mm_weight_stationary": 0, **no_lm}),
    }
    # serving a pruned model prunes once: time the pre-pruned forward too
    pruned, _ = cnn.resnet50_prune(r50, 0.5)
    times = []
    for _ in range(FWD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cnn.resnet50_apply(pruned, x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "resnet50_prepruned", "median_ms": statistics.median(times),
          "min_ms": min(times)})
    emit({"phase": "host", **host_profile(lambda: cnn.resnet50_apply(r50, x))})
    zamba2 = run_zamba2(serve, lm, attn_mod, fa_mod, da_mod, counters)

    dump({**details, "times": per_path, "lm_times": lm_times,
          "models": models, "zamba2": zamba2})

    # 7. kernels line (dense ResNet-50 main path), the card, the last line
    sources = {"conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
                          "src/repro/kernels/conv2d.py:57"),
               "mm_act_stationary": ("src/repro_torch/kernels/csrc/matmul.cu",
                                     "src/repro/kernels/matmul.py:75"),
               "mm_weight_stationary": (
                   "src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:149")}
    by_path = {p: m["launches"] for p, m in models.items()}
    by_path["zamba2_prefill"] = zamba2["launches_per_prefill"]
    by_path["zamba2_decode"] = zamba2["launches_per_decode_step"]
    line = []
    for kname, (src, replaces) in sources.items():
        rs = [r for r in per_path["resnet50"] if r["kernel"] == kname]
        t_by = {"operations": 0.0, "bytes": 0.0}
        for r in rs:
            t_by[r["bound_by"]] += r["bound_ms"]
        line.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": models["resnet50"]["launches"][kname],
            "launches_by_path": {p: n[kname] for p, n in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(t_by, key=t_by.get),
            "library_ms": sum(r["library_ms"] for r in rs),
            "shapes": "the dense ResNet-50 forward's calls, fp32, summed"})
    lm_sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:28"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:31"),
        "conv1d_causal": ("src/repro_torch/kernels/csrc/conv1d.cu",
                          "src/repro/kernels/conv1d.py:23")}
    for kname, (src, replaces) in lm_sources.items():
        r = lm_times[kname]
        line.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": zamba2["launches"][kname],
            "launches_by_path": {p: n[kname] for p, n in by_path.items()},
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "shapes": "one call at the zamba2 serving shape, bf16: "
                      + json.dumps({k: v for k, v in r["case"].items()
                                    if k != "kernel"})})
    emit({"kernels": line})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
