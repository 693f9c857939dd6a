"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, the CUDA
toolkit's ``nvcc`` and PyTorch built for CUDA.  It imports only ``torch`` and
``repro_torch`` (from ``src/``), never JAX or the JAX package.  Phases, each
printing one JSON line:

1. device  — fails without CUDA; prints ``nvidia-smi`` name and power limit.
2. build   — compiles every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc.
3. shapes  — a traced forward (plain engine) of each model records the
             shapes and epilogues the main path gives each kernel.
4. checks  — every kernel against its plain PyTorch version on the card, at
             those shapes and a few ragged ones, fp32 and bf16, every
             epilogue combination.  Tolerance: fp32 2e-4 x sqrt(reduction
             length); bf16 the larger of 2e-2 x sqrt(reduction length) and
             one bf16 step at the largest output, 2^-7 x max|plain| (both
             sides round one fp32 sum to bf16 once, summed in different
             orders, so a value next to a rounding boundary may land on the
             neighbouring bf16 value).
5. times   — each kernel, its plain version and the one PyTorch library call
             (cuDNN conv / cuBLAS GEMM with TF32 off, epilogue not included)
             at the fp32 main-path shapes, with CUDA events and a cold L2
             cache, beside the bound max(FLOPs / peak, bytes / bandwidth).
6. resnet50, resnet50_sparse, vgg16 — the full-width batch-1 224x224 fp32
             forwards through ``models.cnn``; launch counts per forward,
             logits against the same forward with ``impl="ref"`` (tolerance
             1e-3 x max|ref|), median forward time on the host clock, and
             under ``torch.profiler`` the device's busy time per forward.
7. the ``kernels`` line, the card, and the last line
   ``{"ok": true, "device": {...}}``.

Per-case details go to ``chiprun_out/chip_smoke_cases.json``.  Any failed
check raises, so the script exits non-zero and prints no last line.
"""
from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
SEED = 0
# Published peaks (NVIDIA data sheets; dense, no sparsity): fp32 on the CUDA
# cores, bf16 on the tensor cores, device-memory bandwidth.
PEAKS = {"sxm": {"fp32": 67e12, "bf16": 989e12, "bw": 3.35e12},
         "pcie": {"fp32": 51e12, "bf16": 756e12, "bw": 2.0e12}}
FWD_REPS = 20
KERNEL_REPS = 10
PROFILE_REPS = 5
SLEEP_CYCLES = 1_000_000     # ~0.5 ms of device time at H100 clocks


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
class Checker:
    """Per-case results of kernel vs plain version, against ``_tol``."""

    def __init__(self):
        self.cases: list[dict] = []

    def add(self, kernel: str, case: dict, got, want, reduction: int):
        err = (got.float() - want.float()).abs().max().item()
        tol = _tol(want, reduction)
        ok = bool(err <= tol) and bool(torch.isfinite(got.float()).all())
        self.cases.append({"kernel": kernel, **case, "max_abs_err": err,
                           "tol": tol, "ok": ok})
        return err

    def failures(self) -> list[dict]:
        return [c for c in self.cases if not c["ok"]]


def _tol(want: torch.Tensor, reduction: int) -> float:
    """The stated tolerance (module docstring, phase 4)."""
    if want.dtype != torch.bfloat16:
        return 2e-4 * reduction ** 0.5
    return max(2e-2 * reduction ** 0.5,
               2.0 ** -7 * want.float().abs().max().item())


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


def device_busy(apply, params, x, kw: dict) -> dict:
    """Device busy time per forward under torch.profiler, and the top kernels.

    Busy time is the union of the device activity intervals; the idle share
    is the rest of the profiled window (the profiler slows the host, so the
    share is an upper bound for an unprofiled run).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    apply(params, x, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_REPS):
            apply(params, x, **kw)
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
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e3 / PROFILE_REPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy / 1e3 / PROFILE_REPS,
            "profiled_wall_ms": wall_ms / PROFILE_REPS,
            "idle_share": 1.0 - busy / 1e3 / wall_ms,
            "top_device_ms": {n[:80]: t for n, t in top}}


def host_profile(apply, params, x, reps: int = PROFILE_REPS) -> dict:
    """Where the host's time per forward goes: cProfile, top functions.

    Host microseconds per forward by own time (``tottime``); cProfile adds
    its own cost to every Python call, so read the ranking, not the sum.
    """
    import cProfile
    import pstats
    apply(params, x)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        apply(params, x)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, nc, f"{Path(fn).name}:{line}:{name}")
                   for (fn, line, name), (_, nc, tt, _, _) in stats.items()),
                  reverse=True)[:15]
    total = sum(v[2] for v in stats.values())
    return {"profiled_us_per_forward": total / reps * 1e6,
            "top_tottime_us_per_forward": {
                where: round(tt / reps * 1e6, 1) for tt, _, where in rows},
            "calls_per_forward": {where: nc // reps for _, nc, where in rows}}


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
           **device_busy(apply, params, x, kw)}
    emit(rec)
    if launches != expected:
        raise SystemExit(f"{name}: launches {launches} != {expected}")
    if not (rec["finite"] and err <= tol):
        raise SystemExit(f"{name}: logits off the plain engine by {err} "
                         f"(tol {tol})")
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
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.models import cnn
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
    ptxas = {n: [line.strip() for line in _build.build_log(n).splitlines()
                 if "registers" in line or "spill" in line]
             for n in ("conv2d", "matmul")}
    emit({"phase": "build", "nvcc_seconds": nvcc_s,
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})

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
            "max_err_over_tol": max(c["max_abs_err"] / c["tol"] for c in cs),
            "max_abs_err_fp32": max(c["max_abs_err"] for c in cs
                                    if c["dtype"] == "float32"),
            "max_abs_err_bf16": max(c["max_abs_err"] for c in cs
                                    if c["dtype"] == "bfloat16")}
    emit({"phase": "checks", "seconds": time.perf_counter() - t0,
          "tolerance": "fp32 2e-4 x sqrt(R); bf16 max(2e-2 x sqrt(R), "
                       "2^-7 x max|plain|)",
          **summary})
    details = {"nvidia_smi": smi, "checks": chk.cases}
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

    # 6. the main path, through the entry points a user calls
    counters = {"conv2d": conv_mod.conv2d,
                "mm_act_stationary": mm_mod.matmul_act_stationary,
                "mm_weight_stationary": mm_mod.matmul_weight_stationary}
    expect_r50 = {"conv2d": 17, "mm_act_stationary": 29,
                  "mm_weight_stationary": 7}
    models = {
        "resnet50": run_model("resnet50", cnn.resnet50_apply, r50, x,
                              counters, expect_r50),
        "resnet50_sparse": run_model("resnet50_sparse", cnn.resnet50_apply,
                                     r50, x, counters, expect_r50,
                                     sparse=True),
        "vgg16": run_model("vgg16", cnn.vgg16_apply, vgg, x, counters,
                           {"conv2d": 13, "mm_act_stationary": 0,
                            "mm_weight_stationary": 0}),
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
    emit({"phase": "host", **host_profile(cnn.resnet50_apply, r50, x)})

    dump({**details, "times": per_path, "models": models})

    # 7. kernels line (dense ResNet-50 main path), the card, the last line
    sources = {"conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
                          "src/repro/kernels/conv2d.py:57"),
               "mm_act_stationary": ("src/repro_torch/kernels/csrc/matmul.cu",
                                     "src/repro/kernels/matmul.py:75"),
               "mm_weight_stationary": (
                   "src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:149")}
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
            "launches_by_path": {p: m["launches"][kname]
                                 for p, m in models.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(t_by, key=t_by.get),
            "library_ms": sum(r["library_ms"] for r in rs),
            "shapes": "the dense ResNet-50 forward's calls, fp32, summed"})
    emit({"kernels": line})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
