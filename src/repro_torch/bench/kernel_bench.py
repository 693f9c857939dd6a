"""Every kernel at the main paths' shapes, from a cold L2, beside its plain
version, its bound and the one PyTorch library call for the same function.

    PYTHONPATH=src python -m repro_torch.bench.kernel_bench [--json OUT]

The port's counterpart of ``benchmarks/kernel_bench.py``, which sweeps the
Pallas kernels against their ``jnp`` oracles.  Here each of the six CUDA
kernels is timed on the card at the shapes its main paths give it, in fp32
and bf16: the three CNN kernels at every call of the batch-1 ResNet-50
(dense and sparse) and VGG-16 forwards (traced with the plain engine, each
call with the model's epilogue), the three LM kernels at zamba2's serving
shapes, decode at the mixtral, scheduler and gemma2 serving shapes,
gemma2's head dim 256 and smollm-360m's smoke head dim 20 (padded to 64 in
the wrapper), and the paths no config has: the wide attention kernels at
dh 512 and conv1d at FL 7.  Per row: the kernel's and its plain version's
(``kernels/ref.py``) cold-L2 device time (``bench.timer``), the max
difference between the two, the library call's time, and the bound
max(FLOPs / peak, bytes / bandwidth) with each input read once and each
output written once (attention counts only the pairs its mask lets in);
beside conv1d two copies of its input (``conv1d_yardsticks``).

    PYTHONPATH=src python -m repro_torch.bench.kernel_bench \
        --conv1d-against OTHER/src/repro_torch/kernels/csrc/conv1d.cu

times only conv1d at zamba2's prefill shape, FL 7 and 4, this tree's
kernel in turns with another tree's (``conv1d_turns``).

This module also holds the pieces ``chip_smoke.py`` shares with it: the
main paths' shapes and case lists, each kernel's operands, cost and
library call.  Without a CUDA device the CLI exits nonzero and says so.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch
import torch.nn.functional as F

from .timer import REPS, cold_time_ms, flush_buffer

# Published peaks (NVIDIA data sheets; dense, no sparsity): fp32 on the CUDA
# cores, bf16 on the tensor cores, device-memory bandwidth.
PEAKS = {"sxm": {"fp32": 67e12, "bf16": 989e12, "bw": 3.35e12},
         "pcie": {"fp32": 51e12, "bf16": 756e12, "bw": 2.0e12}}
# The LM paths' shapes (``chip_smoke.py`` serves and trains at them):
# zamba2-2.7b served at batch 4 x 2048-token prompts, 32 tokens out
Z_BATCH, Z_PROMPT, Z_GEN = 4, 2048, 32
# gemma2-9b: one 6144-token prompt, 16 tokens out
G_PROMPT, G_GEN = 6144, 16
# mixtral-8x7b: batch 2 x 5120-token prompts (past its 4096 window), 16 out
M_BATCH, M_PROMPT, M_GEN = 2, 5120, 16
# rwkv6-1.6b: batch 4 x 2048-token prompts
R_BATCH, R_PROMPT = 4, 2048
# the continuous-batching scheduler: 4 slots, prompt lengths and budgets
S_SLOTS, S_PROMPT_RANGE, S_BUDGET_RANGE = 4, (512, 6144), (4, 16)
# training: smollm-360m at train_4k's sequence, batch 8; zamba2 B 2 x 2048
TS_BATCH, TS_SEQ = 8, 4096
TZ_BATCH, TZ_SEQ = 2, 2048
# smollm-360m's smoke config served on the card (3 heads over 1 of dh 20)
SD_BATCH, SD_PROMPT, SD_GEN = 2, 64, 16


def peaks_for(name: str) -> dict:
    """The published peaks of the card named ``name`` (SXM unless PCIe)."""
    return PEAKS["pcie" if "PCIe" in name else "sxm"]


# ------------------------------------------------------------ CNN ------
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

    def run_tuned(self, call, x, w, ep, tiles):
        """The call under a tuned plan; a 1x1 takes the entry's
        stationarity, as the dispatch does."""
        if call["kernel"] == "conv2d":
            return self.conv.conv2d(x, w, stride=call["stride"],
                                    padding=call["padding"], tiles=tiles,
                                    **ep)
        wrapper = (self.wrappers["mm_weight_stationary"]
                   if tiles.stationarity == "weight_stationary"
                   else self.wrappers["mm_act_stationary"])
        return wrapper(x, w, stride=call["stride"], tiles=tiles, **ep)

    def plan(self, call, x, w, ep) -> dict:
        """The launch plan the wrapper makes for these operands: tile,
        splits and gather path."""
        if call["kernel"] == "conv2d":
            p = self.conv.launch_plan(x, w, stride=call["stride"],
                                      padding=call["padding"],
                                      residual=ep["residual"])
        else:
            planner = (self.mm.ws_plan
                       if call["kernel"] == "mm_weight_stationary"
                       else self.mm.act_plan)
            p = planner(x, w, stride=call["stride"], residual=ep["residual"])
        return {"tile": [p.bm, p.bn, p.groups], "splits": p.splits,
                "per": p.per, "path": p.path}

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
    rn = lambda *s: torch.randn(s, device=gen.device, generator=gen)
    off = call.get("offset", 0)
    x = rn(math.prod(call["x"]) + off).to(dtype)[off:].view(call["x"])
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

def time_cnn_call(kern: Kernels, call: dict, dtype, flush, gen,
                  reps: int = REPS) -> dict:
    """One CNN call with its epilogue, cold L2: the kernel, its plain
    version and the library call (TF32 off, no epilogue), the max
    difference, FLOPs, bytes and the bound."""
    x, w, full = make_operands(kern, call, dtype, gen)
    ep = model_epilogue(full, call.get("epilogue", "none"))
    err = (kern.run(call, x, w, ep).float()
           - kern.plain(call, x, w, ep).float()).abs().max().item()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = cold_time_ms(kern.library(call, x, w), flush, reps)
    bound, by = kern.bound_ms(call, dtype)
    flops, nbytes = kern.cost(call, dtype)
    return {"kernel": call["kernel"], "x": call["x"], "w": call["w"],
            "stride": call["stride"], "epilogue": call.get("epilogue"),
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "flops": flops, "bytes": nbytes,
            "ms": cold_time_ms(lambda: kern.run(call, x, w, ep), flush, reps),
            "plain_ms": cold_time_ms(lambda: kern.plain(call, x, w, ep),
                                     flush, reps),
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by}


# ------------------------------------------------------------- LM ------
def flash_case(b, t, h, kh, dh, window=0, softcap=0.0, q_offset=0) -> dict:
    """q_offset: q's first row is that position; k and v hold the
    q_offset + t keys it can see (a shard of a sharded sequence)."""
    return dict(kernel="flash_attention", b=b, t=t, h=h, kh=kh, dh=dh,
                window=window, softcap=softcap, q_offset=q_offset)


def decode_case(b, s, h, kh, dh, pos, window=0, softcap=0.0, ring=0,
                k_offset=0, lse=False) -> dict:
    """pos: the model's position per sequence; a ring of ``ring`` slots
    hands the kernel min(pos, ring - 1) (``kernel_pos``); the cache's row 0
    is key ``k_offset`` (a shard of a sharded cache); ``lse``: the
    log-sum-exp is returned too."""
    return dict(kernel="decode_attention", b=b, s=s, h=h, kh=kh, dh=dh,
                pos=pos, window=window, softcap=softcap, ring=ring,
                k_offset=k_offset, lse=lse)


def conv1d_case(b, t, c, fl, row=None, col0=0) -> dict:
    """x is columns [col0, col0 + c) of a (b, t, row) tensor."""
    return dict(kernel="conv1d_causal", b=b, t=t, c=c, fl=fl, row=row or c,
                col0=col0)


def lm_kernel_cases() -> list[dict]:
    """zamba2's main-path shapes first (one per kernel), then ragged ones,
    then the other LM paths' main-path shapes, then smollm-360m's smoke
    head dim (20)."""
    fa, da, c1 = flash_case, decode_case, conv1d_case
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
        # tile edges of the bf16 kernel (128-row query tiles, 16 rows a
        # warp, 64-key tiles, 8-key mma n-tiles): T around 16, 64, 128
        *(fa(b, t, 4, 2, dh) for b, t, dh in (
            (1, 1, 16), (2, 15, 64), (1, 16, 80), (2, 17, 128),
            (1, 63, 80), (2, 65, 64), (1, 127, 128), (2, 129, 80))),
        # windows ending inside an mma n-tile; soft-caps with G = 4
        fa(2, 200, 4, 4, 80, 21), fa(1, 129, 2, 2, 128, 9),
        fa(1, 150, 8, 2, 64, softcap=30.0), fa(2, 129, 8, 2, 128, 0, 50.0),
        fa(1, 257, 16, 4, 80, 37, 20.0), fa(1, 100, 4, 1, 16, 0, 5.0),
        # a different pos per sequence, 0 and S - 1, S off the 64-row chunks
        da(3, 300, 8, 2, 64, (299, 0, 130)), da(2, 129, 4, 4, 128, (128, 64)),
        da(2, 1000, 6, 3, 80, (999, 511)), da(2, 77, 8, 2, 16, (76, 3)),
        # pos on a chunk's last and first row and inside one; B * KH = 1;
        # a cache of one row
        da(4, 300, 8, 2, 80, (63, 64, 100, 128)),
        da(2, 129, 4, 4, 128, (127, 128)), da(1, 200, 4, 1, 64, (150,)),
        da(1, 65, 1, 1, 80, (64,)), da(2, 1, 4, 2, 16, (0, 0)),
        da(1, 1, 8, 1, 128, (0,)),
        # windows over a linear cache: inside one tile, across tiles and
        # splits (the splits before the window read nothing), with caps
        da(3, 300, 8, 2, 64, (299, 0, 130), window=100, softcap=20.0),
        da(2, 1000, 6, 3, 80, (999, 64), window=64),
        da(2, 129, 4, 4, 128, (128, 63), window=1, softcap=5.0),
        # rings (pos is the model's; the kernel sees min(pos, W - 1)):
        # before the ring fills, on its last slot, wrapped
        da(3, 200, 8, 2, 64, (37, 199, 1000), ring=200),
        da(2, 64, 4, 1, 16, (63, 64), softcap=30.0, ring=64),
        # FL 2-4, odd C (one channel a thread), contiguous and strided x
        c1(Z_BATCH, Z_PROMPT, 5248, 4), c1(2, 33, 131, 3), c1(1, 17, 96, 2),
        c1(3, 100, 1000, 4), c1(2, 40, 64, 2, row=80, col0=8),
        # mixtral's prefill (window 4096, T past it); its and the
        # scheduler's decode (decode_path_cases); rwkv6's token shifts
        # (FL 2, C 2048) in prefill and in decode, where the carried row
        # is prepended to the step's
        fa(M_BATCH, M_PROMPT, 32, 8, 128, 4096),
        *decode_path_cases(),
        c1(R_BATCH, R_PROMPT, 2048, 2), c1(R_BATCH, 2, 2048, 2),
        # the training paths' flash calls: smollm-360m (15 over 5 heads of
        # 64) and zamba2's shared attention block (32 over 32 of 80)
        *train_flash_cases(),
        # smollm-360m's smoke config: dh 20, zero-padded to 64
        *dh20_cases(),
        # filter lengths and head dims no config has
        *any_fl_cases(), *wide_head_cases(),
    ]


def any_fl_cases() -> list[dict]:
    """conv1d at FL 1 (a template instance) and 5, 7 and 9 (the kernel that
    takes FL at run time): odd C (one channel a thread), contiguous and
    strided x.  Then the runtime-FL kernel's edges (its blocks cover 128
    time steps and 64 or 32 channels, its slab one chunk of 64 taps): T
    over several blocks and off them, with odd C and strided x at FL 7; T
    below FL; FL past one chunk (65, 128, 129 and 300: the ring of
    chunks), with odd C; and FL 7 at zamba2's prefill shape."""
    c1 = conv1d_case
    return [*(case for fl in (1, 5, 7, 9) for case in (
        c1(2, 33, 131, fl), c1(3, 100, 1000, fl),
        c1(2, 45, 64, fl, row=80, col0=8))),
        c1(2, 300, 1000, 7), c1(2, 300, 131, 7),
        c1(2, 300, 520, 7, row=1040, col0=520),
        c1(2, 5, 64, 9), c1(1, 3, 131, 9),
        c1(2, 300, 200, 65), c1(1, 257, 72, 128, row=80, col0=8),
        c1(2, 400, 200, 129), c1(2, 400, 200, 300), c1(1, 400, 131, 300),
        c1(Z_BATCH, Z_PROMPT, 5248, 7, row=10368, col0=5120)]


def wide_head_cases() -> list[dict]:
    """Flash and decode at head dims above 256 (the wide kernels, dh a
    runtime argument): dh 272, 384, 512 and 1024, each with GQA, a window,
    a soft-cap and a query offset (flash), and a position per row, a
    window over a linear cache, a ring before and after it wraps, a key
    offset with the log-sum-exp and a cache of one row (decode); dh 301;
    dh 2048, the widest (bf16: one warp group of 16 query rows, 16 keys a
    tile); and groups of more heads than a wide block holds (decode: 16 over
    1 at dh 520, two blocks per kv head; flash: 18 over 1 at dh 600)."""
    fa, da = flash_case, decode_case
    out = []
    for dh in (272, 384, 512, 1024):
        out += [fa(1, 150, 4, 2, dh), fa(2, 77, 6, 3, dh, 40, 30.0),
                fa(1, 100, 4, 1, dh, 0, 50.0, q_offset=37),
                fa(1, 65, 2, 2, dh, 17, 0.0, q_offset=5),
                da(3, 300, 8, 2, dh, (299, 0, 130)),
                da(2, 1000, 6, 3, dh, (999, 511), window=100, softcap=20.0),
                da(3, 200, 4, 1, dh, (37, 199, 1000), softcap=30.0,
                   ring=200),
                da(2, 200, 4, 2, dh, (300, 150), k_offset=100, lse=True),
                da(1, 1, 2, 1, dh, (0,))]
    # a row of 301 elements is no whole number of 16-byte pieces: flash
    # copies its K/V tiles element by element
    return out + [fa(1, 70, 4, 2, 301, 20, 30.0), fa(2, 33, 2, 1, 301),
                  da(2, 90, 4, 2, 301, (89, 40), window=50),
                  fa(1, 40, 4, 2, 2048), fa(1, 33, 2, 1, 2048, 9, 30.0,
                                             q_offset=3),
                  da(2, 300, 4, 2, 2048, (299, 77)),
                  da(2, 700, 4, 1, 2048, (699, 300), softcap=20.0, lse=True),
                  da(1, 200, 16, 1, 520, (150,), window=60),
                  fa(1, 70, 18, 1, 600)]


WIDE_DH = 512   # the wide kernels' timed head dim


def wide_time_cases() -> list[dict]:
    """What the wide paths are timed at (no config has them): flash and
    decode at dh WIDE_DH, 8 heads over 4, over 2048 positions (decode B 4
    over the whole cache), and conv1d at FL 7 at zamba2's prefill shape."""
    return [flash_case(1, 2048, 8, 4, WIDE_DH),
            decode_case(4, 2048, 8, 4, WIDE_DH, (2047,) * 4),
            conv1d_case(Z_BATCH, Z_PROMPT, 5248, 7, row=10368, col0=5120)]


def train_flash_cases() -> list[dict]:
    """Flash at the shapes train_smollm and train_zamba2 launch it."""
    return [flash_case(TS_BATCH, TS_SEQ, 15, 5, 64),
            flash_case(TZ_BATCH, TZ_SEQ, 32, 32, 80)]


DECODE_PATH_NAMES = ("mixtral ring, pos < W and W - 1",
                     "mixtral ring, wrapped",
                     "scheduler ring, B 4, a position per row",
                     "gemma2 local ring, cap 50", "gemma2 global linear, cap 50",
                     "gemma2 linear, window 4096, cap 50")


def decode_path_cases() -> list[dict]:
    """Decode at the new paths' shapes (``DECODE_PATH_NAMES``): mixtral's
    ring (B 2, W 4096, 32 heads over 8 of 128) with pos before the ring
    fills, on its last slot and wrapped; the scheduler's step on the same
    ring (B S_SLOTS, each slot at its own position, up to its max_seq - 1);
    gemma2-9b's local layer (ring 4096, cap 50, dh 256) and global layer (a
    linear cache of 6160 rows, cap 50); and a window over gemma2's linear
    cache, whose first splits read nothing."""
    da, w = decode_case, 4096
    s_last = S_PROMPT_RANGE[1] + S_BUDGET_RANGE[1] - 1
    return [da(M_BATCH, w, 32, 8, 128, (1000, w - 1), ring=w),
            da(M_BATCH, w, 32, 8, 128, (w, M_PROMPT + M_GEN - 1), ring=w),
            da(S_SLOTS, w, 32, 8, 128, (600, w - 1, w + 3, s_last), ring=w),
            da(2, w, 16, 8, 256, (G_PROMPT, 3000), softcap=50.0, ring=w),
            da(2, G_PROMPT + G_GEN, 16, 8, 256, (G_PROMPT + G_GEN - 1, 100),
               softcap=50.0),
            da(2, G_PROMPT + G_GEN, 16, 8, 256, (G_PROMPT + G_GEN - 1, 5000),
               window=w, softcap=50.0)]


def kernel_pos(case: dict, pos) -> tuple:
    """The positions the decode kernel is given: a ring of W slots maps
    pos to min(pos, W - 1), as models.attention.attention_decode does."""
    ring = case.get("ring", 0)
    return tuple(min(p, ring - 1) for p in pos) if ring else tuple(pos)


def visible_rows(case: dict, pos) -> list[int]:
    """Keys each sequence's mask lets in at these (model) positions."""
    w = case.get("window", 0)
    return [min(p + 1, w) if w > 0 else p + 1 for p in kernel_pos(case, pos)]


def lm_operands(case: dict, dtype, gen, pos=None):
    """(args, kwargs) of the wrapper for one case, drawn on gen's
    device."""
    rn = lambda *s: torch.randn(s, device=gen.device, generator=gen)
    if case["kernel"] == "flash_attention":
        b, t, h, kh, dh = (case[k] for k in ("b", "t", "h", "kh", "dh"))
        s = t + case.get("q_offset", 0)
        args = (rn(b, t, h, dh), rn(b, s, kh, dh), rn(b, s, kh, dh))
        kw = {"window": case["window"], "softcap": case["softcap"]}
        if case.get("q_offset"):
            kw["q_offset"] = case["q_offset"]
        return tuple(a.to(dtype) for a in args), kw
    if case["kernel"] == "decode_attention":
        b, s, h, kh, dh = (case[k] for k in ("b", "s", "h", "kh", "dh"))
        args = (rn(b, h, dh), rn(b, s, kh, dh), rn(b, s, kh, dh))
        p = torch.tensor(kernel_pos(case, pos or case["pos"]),
                         dtype=torch.int32, device=gen.device)
        kw = {"window": case["window"], "softcap": case["softcap"]}
        if case.get("k_offset"):
            kw["k_offset"] = case["k_offset"]
        if case.get("lse"):
            kw["return_lse"] = True
        return tuple(a.to(dtype) for a in args) + (p,), kw
    b, t, c, fl = (case[k] for k in ("b", "t", "c", "fl"))
    full = rn(b, t, case["row"]).to(dtype)
    return (full[..., case["col0"]:case["col0"] + c], rn(fl, c)), {}


def lm_cost(case: dict, dtype, pos) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: each input read once, each output written
    once; attention counts only the (query, key) pairs its mask lets in
    (timed cases have no query or key offset)."""
    es = torch.tensor([], dtype=dtype).element_size()
    if case["kernel"] == "flash_attention":
        t, w = case["t"], case["window"]
        pairs = sum(min(i + 1, w) if w > 0 else i + 1 for i in range(t))
        flops = 4 * case["b"] * case["h"] * case["dh"] * pairs
        nbytes = 2 * case["b"] * t * (case["h"] + case["kh"]) * case["dh"] * es
        return flops, nbytes
    if case["kernel"] == "decode_attention":
        rows = sum(visible_rows(case, pos))
        flops = 4 * case["h"] * case["dh"] * rows
        nbytes = (2 * case["b"] * case["h"] * case["dh"]
                  + 2 * rows * case["kh"] * case["dh"]) * es + 4 * case["b"]
        return flops, nbytes
    n = case["b"] * case["t"] * case["c"]
    return 2 * n * case["fl"], 2 * n * es + 4 * case["fl"] * case["c"]


def lm_library(case: dict, args):
    """The one PyTorch call for the same function (a yardstick only):
    SDPA, causal or masked to the window (it has no soft-cap, so at a
    soft-capped case it is a yardstick of the shape), or with the decode
    position mask; depthwise F.conv1d."""
    if case["kernel"] == "flash_attention":
        q, k, v = (a.transpose(1, 2) for a in args)          # (B, H, T, dh)
        if not case["window"]:
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        i = torch.arange(case["t"], device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                             - case["window"])
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)
    if case["kernel"] == "decode_attention":
        q, ck, cv, pos = args
        q4 = q[:, :, None, :]
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
        j = torch.arange(ck.shape[1], device=q.device)[None, :]
        mask = j <= pos[:, None]
        if case.get("window", 0) > 0:
            mask = mask & (j > pos[:, None] - case["window"])
        mask = mask[:, None, None, :]
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


def dh256_cases() -> list[dict]:
    """gemma2-9b's attention (dh 256, 16 heads over 8 kv heads): a local
    (window 4096) and a global layer's prefill at T 6144 and 37 rows off the
    tiles, soft-cap 50; decode over a 6144-row cache, pos at S - 1, 0,
    inside and on a 64-row chunk's last row."""
    fa = lambda t, window: dict(kernel="flash_attention", b=1, t=t, h=16,
                                kh=8, dh=256, window=window, softcap=50.0)
    return [fa(G_PROMPT, 4096), fa(G_PROMPT, 0), fa(G_PROMPT - 37, 4096),
            fa(G_PROMPT - 37, 0),
            dict(kernel="decode_attention", b=4, s=G_PROMPT, h=16, kh=8,
                 dh=256, pos=(G_PROMPT - 1, 0, 3000, 4095), window=0,
                 softcap=0.0, ring=0)]

def time_lm_case(wrapper, plain, case: dict, dtype, peaks: dict, flush, gen,
                 pos=None, reps: int = REPS, plain_reps: int = REPS) -> dict:
    """One LM kernel call, cold L2, at ``pos`` (decode; default the case's
    own positions): the kernel, its plain version and the library call
    (``lm_library``), the max difference, FLOPs, bytes and the bound."""
    args, kw = lm_operands(case, dtype, gen, pos)
    if pos is None and case["kernel"] == "decode_attention":
        pos = case["pos"]
    err = (wrapper(*args, **kw).float()
           - plain(*args, **kw).float()).abs().max().item()
    flops, nbytes = lm_cost(case, dtype, pos or ())
    peak = peaks["bf16" if dtype == torch.bfloat16 else "fp32"]
    t_ops, t_bytes = flops / peak, nbytes / peaks["bw"]
    row = {"case": {**case, "pos": list(pos)} if pos else case,
           "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
           "flops": flops, "bytes": nbytes,
           "ms": cold_time_ms(lambda: wrapper(*args, **kw), flush, reps),
           "plain_ms": cold_time_ms(lambda: plain(*args, **kw), flush,
                                    plain_reps),
           "library_ms": cold_time_ms(lm_library(case, args), flush, reps),
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if case["kernel"] == "decode_attention":
        row["kernel_pos"] = list(kernel_pos(case, pos))
    if case["kernel"] == "conv1d_causal":
        row.update(conv1d_yardsticks(args[0], flush, reps))
    return row


def conv1d_yardsticks(x, flush, reps: int = REPS) -> dict:
    """Two yardsticks of the memory system beside conv1d, not bounds: x (a
    column slice on the main path) copied into a contiguous (B, T, C)
    tensor, which reads and writes what the kernel must; and a clone of a
    contiguous x, the same bytes through PyTorch's vectorised copy."""
    xc = x.contiguous()
    return {"copy_ms": cold_time_ms(
                lambda: x.clone(memory_format=torch.contiguous_format),
                flush, reps),
            "contiguous_copy_ms": cold_time_ms(xc.clone, flush, reps)}


def build_conv1d(source: str):
    """Another tree's ``csrc/conv1d.cu`` built with this tree's nvcc flags
    (against the headers beside it) into a temporary directory and loaded
    with the wrapper's signatures."""
    import ctypes
    import subprocess
    import tempfile
    from pathlib import Path
    from ..kernels import _build, conv1d
    src = Path(source).resolve()
    lib = Path(tempfile.mkdtemp(prefix="conv1d_against_")) / "libconv1d.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(src.parent), "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    out = ctypes.CDLL(str(lib))
    for fn, argtypes in conv1d._SIGNATURES.items():
        getattr(out, fn).argtypes = argtypes
        getattr(out, fn).restype = ctypes.c_int
    return out


def conv1d_with(lib, args, flush=None, reps: int = REPS):
    """conv1d through its wrapper with the build ``lib`` in place of this
    tree's: the output, or with ``flush`` its cold-L2 time."""
    from unittest import mock
    from ..kernels import _build, conv1d
    with mock.patch.object(_build, "load", lambda *_: lib):
        fn = lambda: conv1d.conv1d_causal(*args)
        return cold_time_ms(fn, flush, reps) if flush is not None else fn()


def conv1d_turns(sources: list[str], reps: int = REPS, seed: int = 0) -> dict:
    """This tree's conv1d kernel and each other build of ``sources``
    (``build_conv1d``) through the wrapper, cold L2, in turns (this, other,
    other, this), at zamba2's prefill shape (a column slice of the in_proj
    output) at FL 7 (the runtime-FL kernel) and FL 4 (a template
    instance), bf16 and fp32; beside them the two copies of
    ``conv1d_yardsticks``, depthwise F.conv1d and the bound, and each
    build's largest difference from this tree's output."""
    from ..kernels import _build, conv1d
    peaks = peaks_for(torch.cuda.get_device_name(0))
    ours = _build.load("conv1d", conv1d._SIGNATURES)
    others = {src: build_conv1d(src) for src in sources}
    flush = flush_buffer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for fl in (7, 4):
            case = conv1d_case(Z_BATCH, Z_PROMPT, 5248, fl, row=10368,
                               col0=5120)
            args, _ = lm_operands(case, dtype, gen)
            flops, nbytes = lm_cost(case, dtype, ())
            peak = peaks["bf16" if dtype == torch.bfloat16 else "fp32"]
            row = {"case": case, "dtype": str(dtype).removeprefix("torch."),
                   "bound_ms": max(flops / peak, nbytes / peaks["bw"]) * 1e3,
                   "library_ms": cold_time_ms(lm_library(case, args), flush,
                                              reps),
                   **conv1d_yardsticks(args[0], flush, reps), "against": {}}
            want = conv1d_with(ours, args).float()
            for src, lib in others.items():
                ms = [conv1d_with(x, args, flush, reps)
                      for x in (ours, lib, lib, ours)]
                row["against"][src] = {
                    "ms": [ms[0], ms[3]], "other_ms": [ms[1], ms[2]],
                    "max_abs_diff": (conv1d_with(lib, args).float()
                                     - want).abs().max().item()}
            rows.append(row)
    return {"rows": rows}


def dh20_cases() -> list[dict]:
    """smollm-360m's smoke config on the card (3 heads over 1 of dh 20,
    which the wrappers pad to 64): its prefill flash and a decode step."""
    s = SD_PROMPT + SD_GEN
    return [flash_case(SD_BATCH, SD_PROMPT, 3, 1, 20),
            decode_case(SD_BATCH, s, 3, 1, 20, (SD_PROMPT, s - 1))]


def time_padding(case: dict, dtype, flush, gen, pos=None,
                 reps: int = REPS) -> dict:
    """What a head dim between the built ones pays for its padding, cold
    L2: the wrapper (q, k and v zero-padded to the next built head dim, one
    launch, the output sliced back) beside the same launch on operands
    padded beforehand, and the three pads alone.  The wrapper's time less
    the pre-padded launch's is the padding's cost; the two launches must
    give the same bits."""
    from ..kernels import decode_attention as da
    from ..kernels import flash_attention as fa
    args, kw = lm_operands(case, dtype, gen, pos)
    dh = case["dh"]
    width = fa.padded_head_dim(dh)
    pad = lambda t: F.pad(t, (0, width - dh))
    wide = tuple(pad(t) for t in args[:3]) + args[3:]
    if case["kernel"] == "flash_attention":
        wrapper = fa.flash_attention
        built = lambda: fa._launch_built(*wide, **kw, q_offset=0,
                                         scale=dh ** -0.5)
    else:
        wrapper = da.decode_attention
        built = lambda: da._launch(*wide, **kw, k_offset=0,
                                   return_lse=False, scale=dh ** -0.5)
    same = torch.equal(built()[..., :dh], wrapper(*args, **kw))
    wrapper_ms = cold_time_ms(lambda: wrapper(*args, **kw), flush, reps)
    built_ms = cold_time_ms(built, flush, reps)
    return {"padded_head_dim": width, "wrapper_ms": wrapper_ms,
            "prepadded_launch_ms": built_ms,
            "padding_ms": wrapper_ms - built_ms,
            "pads_alone_ms": cold_time_ms(
                lambda: [pad(t) for t in args[:3]], flush, reps),
            "prepadded_bits_equal": same}


def bench_cases() -> list[tuple[str, dict, tuple | None]]:
    """(name, case, decode positions) of every LM row: zamba2's serving
    shapes (decode over the whole cache), decode at the other serving
    paths' shapes, gemma2's dh 256 and smollm-360m's smoke dh 20."""
    z_flash, z_decode, z_conv = lm_kernel_cases()[:3]
    g_flash, g_decode = dh256_cases()[1], dh256_cases()[-1]
    rows = [("zamba2", z_flash, None),
            ("zamba2, whole cache", z_decode, (z_decode["s"] - 1,) * Z_BATCH),
            ("zamba2", z_conv, None),
            ("gemma2 dh 256", g_flash, None),
            ("gemma2 dh 256, whole cache", g_decode,
             (g_decode["s"] - 1,) * g_decode["b"])]
    rows += [(n, c, None) for n, c in zip(DECODE_PATH_NAMES,
                                          decode_path_cases(), strict=True)]
    rows += [("smollm-360m smoke dh 20", c, None) for c in dh20_cases()]
    rows += [(f"wide dh {WIDE_DH}" if c["kernel"] != "conv1d_causal"
              else "zamba2, FL 7", c, None) for c in wide_time_cases()]
    return rows


def cnn_calls(seed: int = 0) -> list[dict]:
    """The unique kernel calls of the batch-1 224x224 ResNet-50 (dense and
    sparse) and VGG-16 forwards, each with its epilogue, in that order."""
    from ..models import cnn
    from ..observability import trace
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, 224, 224, 3), generator=gen).cuda()
    r50 = cnn.resnet50_init(torch.Generator().manual_seed(seed))
    vgg = cnn.vgg16_init(torch.Generator().manual_seed(seed + 1))
    unique = {}
    for apply, params, kw in ((cnn.resnet50_apply, r50, {}),
                              (cnn.resnet50_apply, r50, {"sparse": True}),
                              (cnn.vgg16_apply, vgg, {})):
        for c in main_path_shapes(trace, apply, params, x, kw):
            unique.setdefault((c["kernel"], c["x"], c["w"], c["stride"],
                               c["padding"], c["epilogue"]), c)
    return list(unique.values())


def kernel_table(reps: int = REPS, seed: int = 0) -> tuple:
    """(title, headers, rows, records) of every kernel x shape x dtype."""
    from ..kernels import conv1d, conv2d, decode_attention, flash_attention
    from ..kernels import matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = peaks_for(torch.cuda.get_device_name(0))
    kern = Kernels(conv2d, matmul, peaks)
    lm = {"flash_attention": (flash_attention.flash_attention,
                              flash_attention.flash_attention_plain),
          "decode_attention": (decode_attention.decode_attention,
                               decode_attention.decode_attention_plain),
          "conv1d_causal": (conv1d.conv1d_causal, conv1d.conv1d_causal_plain)}
    flush = flush_buffer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for call in cnn_calls(seed):
            records.append({"path": "cnn",
                            **time_cnn_call(kern, call, dtype, flush, gen,
                                            reps)})
        for name, case, pos in bench_cases():
            wrapper, plain = lm[case["kernel"]]
            records.append({"path": name, "kernel": case["kernel"],
                            **time_lm_case(wrapper, plain, case, dtype,
                                           peaks, flush, gen, pos, reps)})
            if case["kernel"] != "conv1d_causal" \
                    and case["dh"] < flash_attention.HEAD_DIMS[-1] \
                    and case["dh"] not in flash_attention.HEAD_DIMS:
                records[-1]["padding"] = time_padding(case, dtype, flush,
                                                      gen, pos, reps)
    rows = []
    for r in records:
        shape = (f"x{list(r['x'])} w{list(r['w'])}" if "x" in r else
                 json.dumps({k: v for k, v in r["case"].items()
                             if k not in ("kernel", "pos")}))
        rows.append([r["kernel"], r["path"], shape, r["dtype"],
                     f"{r['ms']:.4f}", f"{r['plain_ms']:.4f}",
                     f"{r['library_ms']:.4f}", f"{r['bound_ms']:.4f}",
                     r["bound_by"], f"{r['max_abs_err']:.1e}"])
    return ("Kernel bench (CUDA kernels vs plain versions, cold L2, ms)",
            ["kernel", "path", "shape", "dtype", "ms", "plain ms",
             "library ms", "bound ms", "bound by", "max err"], rows, records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="write every row, the card and its power limit here")
    ap.add_argument("--conv1d-against", nargs="+", metavar="CONV1D_CU",
                    help="time only conv1d at zamba2's prefill shape, this "
                         "tree's kernel in turns with each of these builds "
                         "of another tree's csrc/conv1d.cu (conv1d_turns)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device; the kernels run on an NVIDIA "
              "GPU (an H100)", file=sys.stderr)
        return 1
    from ..core import autotune
    device = {"name": autotune.device_name(),
              "power_limit": autotune.power_limit()}
    if args.conv1d_against:
        out = {"device": device, "timer": "cuda_event_cold_l2", "reps": REPS,
               **conv1d_turns(args.conv1d_against)}
        for r in out["rows"]:
            print(json.dumps({**r, "case": {k: r["case"][k] for k in (
                "b", "t", "c", "fl", "row")}}))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    title, headers, rows, records = kernel_table()
    print(f"=== {title} ===")
    widths = [max(len(h), *(len(r[i]) for r in rows))
              for i, h in enumerate(headers)]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    for r in records:
        if "padding" in r:
            p = r["padding"]
            print(f"{r['kernel']} {r['path']} {r['dtype']}: dh "
                  f"{r['case']['dh']} padded to {p['padded_head_dim']}: "
                  f"wrapper {p['wrapper_ms']:.4f} ms, pre-padded launch "
                  f"{p['prepadded_launch_ms']:.4f} ms, padding "
                  f"{p['padding_ms']:.4f} ms, pads alone "
                  f"{p['pads_alone_ms']:.4f} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": device, "timer": "cuda_event_cold_l2",
                       "reps": REPS, "rows": records}, f, indent=1,
                      default=list)
        print(f"rows -> {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
