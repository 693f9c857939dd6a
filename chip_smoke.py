"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, the CUDA
toolkit's ``nvcc`` and PyTorch built for CUDA.  It imports only ``torch`` and
``repro_torch`` (from ``src/``), never JAX or the JAX package.  Phases, each
printing one JSON line:

1. device  — fails without CUDA; prints ``nvidia-smi`` name and power limit.
2. build   — compiles every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
             (one process each, in parallel) and lists each kernel's
             registers and spills, and per library the tensor-core
             instructions in its SASS (``cuobjdump -sass``: HMMA for
             mma.sync, HGMMA for wgmma), which shows the bf16 flash kernel
             on the tensor cores.
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
             dims 16, 64, 80, 128, T and S off the tiles and at their edges
             (T 1, 15-17, 63, 65, 127, 129), windows ending inside an mma
             tile, soft-caps with G = 4, a different pos per sequence with
             0, S - 1, inside a decode chunk and on its boundary, B * KH =
             1, a cache of one row, decode with soft-caps, windows over a
             linear cache (inside a tile, across tiles and splits) and
             rings (pos before the ring fills, on its last slot, wrapped;
             the kernel given min(pos, W - 1)), FL 2-4, odd C, strided
             input), and at the other LM paths' main-path shapes: mixtral's
             prefill flash (T 5120 past its window of 4096), decode at the
             mixtral, scheduler (B 4, a position per row) and gemma2
             serving shapes, rwkv6's token shifts in prefill and decode
             (FL 2, C 2048); fp32 and bf16.  Every case runs twice and must
             give the same bits (for decode: the combine's fixed order, the
             ticket counters' reset).
             Tolerance:
             attention fp32 1e-4 (unit-normal inputs, as
             tests/test_kernels.py); bf16 per output element 2^-6 x
             sum_j p_j |v_j| (the plain version on |v| in fp32): p is
             rounded to bf16 on each side and so is the output, four unit
             roundoffs of 2^-8 of that sum at most; conv1d as phase 4 with
             R = FL.
   cnn_faults — faults planted in csrc/gemm_pipe.cuh, the loop of conv2d
             and both 1x1 GEMMs (``CNN_FAULTS``: text edits, each built
             with csrc/conv2d.cu and csrc/matmul.cu in a temporary
             directory, in parallel with phase 2); the fp32 conv2d and
             weight-stationary checks at the main-path shapes, at the same
             tolerance, must fail on every one, and the dropped split on a
             weight-stationary case.
   flash_bf16_faults — the bf16 flash kernel shares no code with the fp32
             one that the zamba2 wiring check runs, so faults are planted
             in its source (``FLASH_BF16_FAULTS``: text edits of
             csrc/flash_attention.cu, each built apart in a temporary
             directory, in parallel with phase 2) and the bf16 flash cases
             above, at the same tolerance, must fail on every one.
5. times   — each CNN kernel, its plain version and the one PyTorch library
             call (cuDNN conv / cuBLAS GEMM with TF32 off, epilogue not
             included) at the fp32 main-path shapes, and each LM kernel at
             zamba2's bf16 shapes (library: scaled_dot_product_attention,
             causal or with a position mask, and depthwise F.conv1d), with
             CUDA events and a cold L2 cache, beside the bound
             max(FLOPs / peak, bytes / bandwidth); and, as the floor of
             that clock, a trivial one-block kernel timed the same way.
             Each weight-stationary main-path call is also run once under
             ``torch.profiler``, which must see exactly one device kernel
             (its splits are combined in the launch).
   attn_dh256 — gemma2-9b's attention (head dim 256, 16 heads over 8 kv
             heads): flash at T 6144 and 6144 - 37, window 4096 and 0,
             soft-cap 50, and decode over a 6144-row cache (B 4), fp32 and
             bf16, against the plain versions at the lm_checks tolerance
             (decode twice, the same bits); the DH 256 instances' ptxas
             registers and spills (none may spill); bf16 times at the full
             shapes beside the bound, the plain version and SDPA (causal or
             window-masked; SDPA has no soft-cap); and decode at the
             mixtral, scheduler and gemma2 serving shapes (mixtral's ring
             before and after it wraps, B 4 with a position per row,
             gemma2's local ring and global linear cache
             with soft-cap 50, a window over the linear cache), bf16, cold
             L2, beside the bound (the rows the mask lets in), the plain
             version and SDPA with the same position mask.
6. resnet50, resnet50_sparse, vgg16 — the full-width batch-1 224x224 fp32
             forwards through ``models.cnn``; launch counts per forward,
             logits against the same forward with ``impl="ref"`` (tolerance
             1e-3 x max|ref|), median forward time on the host clock, and
             under ``torch.profiler`` the device's busy time per forward.
   tune    — every layer of ResNet-50 (dense and sparse) and VGG-16 tuned
             by ``repro_torch.launch.tune`` into a temporary user cache;
             then, tuner on, each forward counted and held to the untuned
             one (1e-3 x max|untuned|), every traced carla_conv and kernel
             span carrying its layer's entry (tuned=True, its tile), every
             main-path call's tuned output held to its plain version (the
             checks' tolerance) and timed against the analytic plan (cold
             L2), forward medians tuner on and off, and how many layers
             changed plan.  A committed table (kernels/tuned/) must not be
             stale.
   report  — the planned-vs-measured table (``observability.report``, the
             paper's Table II) of one traced ResNet-50 forward, printed; its
             Chrome trace (``observability.export``) written to a temporary
             file must parse with one complete event per span.
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
             sees half the keys) must each fail the fp32 check.
   gemma2, mixtral, rwkv6 — served at full width through
             ``launch.serve`` as zamba2 (``serve_path``): exact launches per
             prefill, per step and per run, the prefill's and 7 decode
             steps' logits against the plain engine in bf16 and fp32 (same
             tolerances), planted faults caught by the fp32 check, host-clock
             medians, peak memory, device busy time and idle share.  For
             mixtral the two bf16 engines take the plain fp32 engine's
             expert choices (bf16 top-k routing is discontinuous); the fp32
             kernel engine routes on its own and must choose as the plain
             fp32 engine did.  gemma2-9b: d_model 3584, 16 heads of 256, vocab 256000, 4 of
             42 layers (two local on rings of 4096, two global on linear
             caches; soft-cap 50), one 6144-token prompt, 16 tokens; 4
             flash per prefill, 4 decode per step; faults: half the window
             in the first of every two flash calls, the decode kernel
             without its soft-cap.  mixtral-8x7b: d_model 4096, 32 heads
             over 8 of 128, d_ff 14336, 8 experts top-2, window 4096, vocab
             32000, 4 of 32 layers, batch 2 x 5120-token prompts (prefill
             rolls the rings, decode wraps them), 16 tokens; 4 flash per
             prefill, 4 decode per step; faults: the ring decoded as a
             linear cache at the slot (slot taken for position), the
             prefill's ring not rolled.  rwkv6-1.6b: full width and depth
             (24 layers, 32 heads of 64, d_ff 7168, vocab 65536), batch 4 x
             2048-token prompts (the chunked WKV form), 32 tokens; 48
             conv1d (the token shifts) per prefill and per step; fault:
             the decode token shift without its carried row.
   scheduler — ``serving.ContinuousBatcher`` on mixtral's weights: 4
             slots, 8 requests (prompts of 512-6144 tokens, budgets of 4-16,
             drawn from the seed); exact launches, each request admitted
             and completed once with its budget, counters and events in
             agreement, slot occupancy; the same run in fp32 must give the
             tokens of ``impl="ref"`` (a difference prints its request,
             step and top-2 logit margins).
   train_kernels — (after flash_bf16_faults) the autograd Functions of
             the two kernels on the training path, ``FlashAttention`` and
             ``Conv1dCausal`` (``train_kernel_cases``: flash at smollm's and
             zamba2's heads, dh 64 and 80, one case windowed and soft-capped;
             conv1d at FL 4 on a strided slice and FL 2), fp32 and bf16: the
             forward equal to the kernel's own launch, bit for bit; every
             input's gradient under a random cotangent against autograd
             through the plain version in one piece, within fp32 1e-4 x
             max(1, max|ref|), bf16 2^-6 x max(1, max|ref|) (the Function's
             backward differentiates the plain version by blocks of query
             rows, rounding each block's gradient to bf16 before the sum);
             a planted fault (dv of the last KV head zeroed) must fail
             every flash case.
   train_smollm — smollm-360m trained at full width and depth (32 layers,
             d_model 960, 15 heads over 5 of 64, d_ff 2560, vocab 49152,
             tied) through ``launch.steps.make_train_step`` and
             ``runtime.TrainSupervisor``: fp32 masters, bf16 activations,
             AdamW (lr 3e-4), ``SyntheticTokenDataset`` seed 0 at B 8 x T
             4096 (train_4k's sequence; its global batch of 256 cut to 8),
             6 steps with a checkpoint every 3 under deterministic
             algorithms, then a fresh supervisor restores step 3 and runs
             steps 4-6 again.  Checks: exact launches per step (64 flash:
             32 forward + 32 recomputed by the remat; nothing else), every
             loss finite, step 1's within 0.5 of ln 49152, the mean of
             steps 5-6 below step 1, the restored state equal to the saved
             one bit for bit, the cursor 3, the resumed losses equal to the
             uninterrupted run's bit for bit; the fp32 wiring gate (2
             layers at full width, B 2 x 1024: the kernel engine's loss and
             every gradient leaf within 1e-3 x max(1, max|ref|) of
             ``impl="ref"``, the planted dv fault failing it); the bf16 loss
             gate on the first batch (|kernels - plain fp32| <= sqrt(2) x
             |plain bf16 - plain fp32| + 1e-3).  Prints the step time
             (median of steps 2-6, host clock after the loss is read),
             tokens/s, peak memory, model TFLOP/s (6 N tokens plus
             attention) beside the H100 SXM's published dense bf16 peak,
             one profiled step's device busy time, idle share and top
             device ops, and the plain attention backward's CUDA-event time
             per layer.  The checkpoints go to chiprun_out/ and are deleted
             at the end.
   train_zamba2 — zamba2-2.7b trained at full width, one group (6 Mamba2
             blocks and the shared attention block), B 2 x 2048, 3 AdamW
             steps with the plain SSD scan inside: exact launches per step
             (12 conv1d, 2 flash), finite losses, and the fp32 wiring gate
             at B 1 x 512 with a planted conv1d fault (dw of the newest tap
             zeroed) failing it.
   shard_splits — (after the times phase) flash and decode at the offsets
             a shard of a sharded sequence or cache sees, on this one card
             (``shard_split_cases``): flash at zamba2's heads over T 4096
             and gemma2's dh 256 at T 6144 (global, and window 4096 with
             soft-cap 50) cut into 2, 4 and 8 query shards, each launched
             with its ``q_offset`` and its key prefix and the outputs
             concatenated; decode over zamba2's linear cache (a position 0
             that leaves all shards but the first with no visible row), a
             window over it (shards wholly before it), and a ring of 1024
             before and after it wraps, the cache cut into 2, 4 and 8
             shards, each launched with its ``k_offset`` and log-sum-exp
             and combined (``decode_attention.combine_shards``); fp32 and
             bf16.  Each split against the plain unsplit version at the
             lm_checks tolerance, the plain version split the same way too,
             and whether its bits equal the unsplit launch (printed, not
             required); a planted fault, every offset but the first one row
             off, must fail each (case, split) in fp32 or bf16.  Beside
             them the times phase's offset-0 flash and decode times at
             zamba2's shapes and those kernels' times before they took
             offsets (0.3628 and 0.0503 ms, PERF.md).
   sharded — (after train_zamba2) the sharded steps of ``launch.steps`` on a (1, 1)
             ('data', 'model') mesh over a one-process NCCL group (a
             ``FileStore`` in a temporary directory): zamba2-2.7b served at
             full width and depth as phase zamba2 (same weights and
             prompts, 4 x 2048, 32 tokens) through ``make_prefill`` and
             ``make_decode_step`` (``serve.generate_sharded``): exact
             launches (54 conv1d and 9 flash per prefill, 9 decode per
             step), the prefill's and LM_COMPARE - 1 teacher-forced decode
             steps' logits against the unsharded kernel path within phase
             zamba2's strictest bf16 tolerance (the max difference and bit
             equality printed); smollm-360m trained at full width and depth
             (B 8 x 4096, AdamW, train_smollm's seed and batches, under
             deterministic algorithms) for SH_TRAIN_STEPS steps of the
             sharded ``make_train_step``: exact launches, the losses within
             1e-4 x |loss| of train_smollm's first ones (bit equality
             printed).  Host-clock medians, the device's busy time and idle
             share of a decode step, a prefill and a train step, beside the
             unsharded phases', and where the decode step's host time goes
             (the DTensor dispatch cost).
   perf_off — (last) the paper-faithful off path of each §Perf flag
             (``repro_torch.perf``), served through ``models.lm`` at a
             path's full width, beside the same path's phase under the
             default flags in this run.  main() pins the default flags
             before phase 1, whatever ``REPRO_PERF`` says; this phase sets
             its own with ``perf.baseline()``/``perf.flags`` around each
             path.  gemma2-9b under ``baseline()`` (phase gemma2's 4
             layers, 1 x 6144, 16 out; ``serve_path``): its local layers'
             caches linear, 6160 rows, and flash and decode on fp32
             copies (the fp32 instances at dh 256); logits against the
             plain engine under the same flags by the bf16 and fp32 gates
             of phase zamba2, no planted fault.  zamba2-2.7b decode under
             ``bf16_attn_io=False`` (4 x 2048, 32 out; ``serve_path``
             with PO_COMPARE decode steps compared, PO_TIMED runs timed):
             each of the 9 decode launches a step reads fp32 copies of its
             cache.  rwkv6-1.6b's prefill under ``rwkv_chunked=False``
             (the per-token WKV, 4 x 2048; ``run_rwkv_per_token``): its
             launches, host time, peak, its logits' distance from the
             chunked form's (printed), busy time and idle share of the
             per-token and chunked prefills cut to PO_RWKV_PROFILE_T tokens
             (the full per-token trace takes minutes to read), and an fp32
             wiring gate at PO_RWKV_GATE (kernel engine against
             ``impl="ref"``, 1e-3 x max(1, max|ref|)).  mixtral-8x7b's
             prefill under
             ``bf16_moe_dispatch=False`` (4 layers, 2 x 5120; the fp32
             combine tensor): the gates on the prefill's logits, and
             whether they equal the default's bit for bit (printed).
             Every path's launches per prefill and per decode step must
             equal its default phase's.  ``grouped_moe_dispatch`` and
             ``tp_serving_params`` change nothing on one card (a (1, 1)
             mesh has no 'model' or 'data' width), so this phase does not
             run them; ``tests/test_torch_perf.py`` holds them on a (2, 2)
             gloo mesh on the CPU.  Prints each path's prefill and decode
             latency, busy time and idle share, peak memory and (gemma2)
             the local caches' bytes, baseline beside default.
7. the ``kernels`` line, the card, and the last line
   ``{"ok": true, "device": {...}}``.

Per-case details go to ``chiprun_out/chip_smoke_cases.json``.  Any failed
check raises, so the script exits non-zero and prints no last line.
"""
from __future__ import annotations

import atexit
import ctypes
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
Z_BATCH, Z_PROMPT, Z_GEN = 4, 2048, 32
# gemma2-9b serving at full width: 4 of its 42 layers (two local, two
# global), one 6144-token prompt, 16 tokens out
G_LAYERS, G_PROMPT, G_GEN = 4, 6144, 16
# mixtral-8x7b serving at full width: 4 of its 32 layers, batch 2 x
# 5120-token prompts (past the 4096 window: prefill rolls the rings and
# decode wraps them), 16 tokens out
M_LAYERS, M_BATCH, M_PROMPT, M_GEN = 4, 2, 5120, 16
# rwkv6-1.6b serving at full width and depth: batch 4 x 2048-token prompts
# (the chunked WKV form), 32 tokens out
R_BATCH, R_PROMPT, R_GEN = 4, 2048, 32
# the continuous-batching scheduler on mixtral's weights: 4 slots, 8
# requests, prompt lengths and budgets drawn from the seed
S_SLOTS, S_REQUESTS, S_PROMPT_RANGE, S_BUDGET_RANGE = 4, 8, (512, 6144), (4, 16)
# smollm-360m trained at full width and depth: train_4k's sequence of 4096
# (its global batch of 256 cut to 8 for one card), AdamW at lr 3e-4, 6 steps
# through the supervisor with a checkpoint every 3, then steps 4-6 again
# from the step-3 checkpoint; its fp32 wiring gate at (layers, batch, seq)
TS_BATCH, TS_SEQ, TS_STEPS, TS_CKPT_EVERY, TS_LR = 8, 4096, 6, 3, 3e-4
TS_GATE = (2, 2, 1024)
# zamba2-2.7b trained at full width, depth cut to one group (6 Mamba2 blocks
# and the shared attention block); its fp32 wiring gate at (batch, seq)
TZ_LAYERS, TZ_BATCH, TZ_SEQ, TZ_STEPS = 6, 2, 2048, 3
TZ_GATE = (1, 512)
# shard_splits: shards a sequence or a cache is cut into, and the cold-L2
# bf16 times of flash and decode at zamba2's serving shapes before the
# kernels took shard offsets (PERF.md §6)
SHARD_SPLITS = (2, 4, 8)
BEFORE_OFFSETS_MS = {"flash_attention": 0.3628, "decode_attention": 0.0503}
# phase sharded: smollm-360m's sharded train steps (train_smollm's first)
SH_TRAIN_STEPS = 3
# LM paths: positions compared with the plain engine (the prefill's last
# and the first decode steps'), host-clock runs timed
LM_COMPARE, LM_TIMED = 8, 3
# perf_off: decode steps compared and served runs timed on the zamba2 and
# mixtral baselines (gemma2 keeps LM_COMPARE and LM_TIMED); the prompt
# length at which rwkv6's per-token and chunked prefills are profiled, and
# its fp32 wiring gate at (batch, T)
PO_COMPARE, PO_TIMED = 2, 1
PO_RWKV_PROFILE_T, PO_RWKV_GATE = 256, (1, 256)
# Faults planted in the bf16 flash kernel (flash_mma_kernel), name -> (text
# of csrc/flash_attention.cu, its replacement); the bf16 flash cases must
# catch each.  The first two touch only rows from 1024 on, which only the
# zamba2-shaped case has: long rows, where one key or one tile moves the
# output least.
FLASH_BF16_FAULTS = {
    "long_rows_skip_a_tile": (       # keys 192-255
        "      continue;\n\n    // The tile's work",
        "      continue;\n    if (q0 >= 1024 && tile0 + it == 3) continue;"
        "\n\n    // The tile's work"),
    "long_rows_mask_their_own_key": (
        "              const bool ok = key <= t && key < s.S &&",
        "              const bool ok = (key < t || (key == t && t < 1024)) "
        "&& key < s.S &&"),
    "row_sum_not_rescaled": ("          l[mt][r] *= alpha;\n", ""),
}
# Faults planted in the CNN kernels' loop (csrc/gemm_pipe.cuh), name ->
# (text, its replacement), each built into a conv2d and a matmul library;
# the fp32 conv2d and weight-stationary checks at the main-path shapes must
# catch each.
CNN_FAULTS = {
    # vec16: the tap walk wraps one column early, so the last filter
    # column is never read (and later taps are shifted)
    "tap_walk_skips_last_column": ("if (++t == s.FW) { t = 0; ++r; }",
                                   "if (++t == s.FW - 1) { t = 0; ++r; }"),
    # the last block of a tile sums every split but the last
    "combine_drops_last_split": ("const int n_split = gridDim.z;",
                                 "const int n_split = gridDim.z - 1;"),
    # general path: the index table sends the last input channel to a tap
    # outside the image, so it reads zeros instead of its value
    "table_drops_last_channel": ("(rr << 16) | tt);",
                                 "c == s.C - 1 ? NO_TAP << 16 "
                                 ": (rr << 16) | tt);"),
}
# Where each planted fault goes: its dict, the file it edits, the sources
# built with it.
PLANTED = ((FLASH_BF16_FAULTS, "flash_attention.cu", ("flash_attention.cu",)),
           (CNN_FAULTS, "gemm_pipe.cuh", ("conv2d.cu", "matmul.cu")))


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


def tensor_core_counts(lib: Path) -> dict | str:
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in a built library's
    SASS, in all and per kernel that has any."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return "not counted: cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts = {"HMMA": 0, "HGMMA": 0, "by_kernel": {}}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        n = {op: len(re.findall(rf"\b{op}\b", part))
             for op in ("HMMA", "HGMMA")}
        counts["HMMA"] += n["HMMA"]
        counts["HGMMA"] += n["HGMMA"]
        if n["HMMA"] or n["HGMMA"]:
            counts["by_kernel"][name[:70]] = n
    return counts


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
    """Prime channel counts, stride 2, the 7x7 stem pattern, odd rows; K
    off the tiles on the vec16 path, an input slice one element off 16-byte
    alignment (``offset``), and a C too short to split."""
    return [
        {"kernel": "conv2d", "x": (2, 9, 11, 48), "w": (3, 3, 48, 72),
         "stride": 1, "padding": 1},
        {"kernel": "conv2d", "x": (1, 20, 20, 16), "w": (3, 3, 16, 24),
         "stride": 2, "padding": 1},
        {"kernel": "conv2d", "x": (1, 12, 12, 32), "w": (3, 3, 32, 20),
         "stride": 1, "padding": 1},
        {"kernel": "conv2d", "x": (1, 14, 14, 64), "w": (3, 3, 64, 64),
         "stride": 1, "padding": 1, "offset": 1},
        {"kernel": "mm_act_stationary", "x": (300, 64), "w": (64, 40),
         "stride": 1, "padding": 0},
        {"kernel": "mm_act_stationary", "x": (1, 15, 15, 256),
         "w": (256, 72), "stride": 2, "padding": 0},
        {"kernel": "mm_act_stationary", "x": (200, 64), "w": (64, 64),
         "stride": 1, "padding": 0, "offset": 1},
        {"kernel": "mm_act_stationary", "x": (8192, 128), "w": (128, 136),
         "stride": 1, "padding": 0},
        {"kernel": "mm_act_stationary", "x": (2, 56, 57, 96), "w": (96, 72),
         "stride": 1, "padding": 0},
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
        {"kernel": "mm_weight_stationary", "x": (1, 7, 7, 32),
         "w": (32, 64), "stride": 1, "padding": 0},
        {"kernel": "mm_weight_stationary", "x": (49, 512), "w": (512, 256),
         "stride": 1, "padding": 0, "offset": 1},
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
    dev = "cuda"
    rn = lambda *s: torch.randn(s, device=dev, generator=gen)
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


def profile_busy(fn, reps: int = PROFILE_REPS, top: int = 6,
                 cpu: bool = True) -> dict:
    """Device busy time per call of fn under torch.profiler, and the top
    ``top`` kernels.

    Busy time is the union of the device activity intervals; the idle share
    is the rest of the profiled window (the profiler slows the host, so the
    share is an upper bound for an unprofiled run).  ``cpu=False`` records
    device activity only (a call of very many small launches).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ms": busy / 1e3 / reps,
            "device_kernels_per_call": len(spans) / reps,
            "profiled_wall_ms": wall_ms / reps,
            "idle_share": 1.0 - busy / 1e3 / wall_ms,
            "top_device_ms": {n[:80]: t for n, t in top}}


def device_kernels(fn, tries: int = 3) -> int:
    """Device kernels (and copies) of one call of fn under torch.profiler.

    A profile that records no device activity at all for a call that
    launched a kernel is the profiler losing its events (seen once in
    about ten runs), not a count: it is taken again, up to ``tries`` times.
    Any other count is returned as it is.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        if n:
            return n
    return 0


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
def flash_case(b, t, h, kh, dh, window=0, softcap=0.0) -> dict:
    return dict(kernel="flash_attention", b=b, t=t, h=h, kh=kh, dh=dh,
                window=window, softcap=softcap)


def decode_case(b, s, h, kh, dh, pos, window=0, softcap=0.0, ring=0) -> dict:
    """pos: the model's position per sequence; a ring of ``ring`` slots
    hands the kernel min(pos, ring - 1) (``kernel_pos``)."""
    return dict(kernel="decode_attention", b=b, s=s, h=h, kh=kh, dh=dh,
                pos=pos, window=window, softcap=softcap, ring=ring)


def conv1d_case(b, t, c, fl, row=None, col0=0) -> dict:
    """x is columns [col0, col0 + c) of a (b, t, row) tensor."""
    return dict(kernel="conv1d_causal", b=b, t=t, c=c, fl=fl, row=row or c,
                col0=col0)


def lm_kernel_cases() -> list[dict]:
    """zamba2's main-path shapes first (one per kernel), then ragged ones,
    then the other LM paths' main-path shapes."""
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
    ]


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
        p = torch.tensor(kernel_pos(case, pos or case["pos"]),
                         dtype=torch.int32, device=DEVICE)
        return (tuple(a.to(dtype) for a in args) + (p,),
                {"window": case["window"], "softcap": case["softcap"]})
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
        rows = sum(visible_rows(case, pos))
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
        j = torch.arange(ck.shape[1], device=DEVICE)[None, :]
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


# ------------------------------------------------------ shard splits ------
def shard_split_cases() -> list[dict]:
    """Phase shard_splits: the flash and decode shapes split as a sharded
    sequence or cache would split them."""
    fa, da = flash_case, decode_case
    zs = Z_PROMPT + Z_GEN
    return [
        # zamba2's heads over a 4096-token sequence; gemma2's dh 256 at its
        # prompt, global and windowed, soft-capped
        fa(2, 2 * Z_PROMPT, 32, 32, 80),
        fa(1, G_PROMPT, 16, 8, 256, 0, 50.0),
        fa(1, G_PROMPT, 16, 8, 256, 4096, 50.0),
        # zamba2's linear cache: pos 0 leaves every shard but the first with
        # no visible row
        da(Z_BATCH, zs, 32, 32, 80, (0, zs - 1, 1000, Z_PROMPT - 1)),
        # a window over the linear cache: shards wholly before it see none
        da(Z_BATCH, zs, 32, 32, 80, (100, zs - 1, 1000, 1500), window=512),
        # a ring of 1024 slots before it wraps and after (min(pos, W - 1))
        da(2, 1024, 32, 8, 128, (300, 700), ring=1024),
        da(2, 1024, 32, 8, 128, (1500, 5119), ring=1024),
    ]


def split_call(case: dict, args, kw, n: int, wrapper, da_mod, fault=0):
    """The call of ``case`` cut into n shards: flash by query rows, each
    shard given its q_offset and its key prefix and the outputs
    concatenated; decode by cache rows, each shard given its k_offset, the
    outputs combined by their log-sum-exps.  ``fault`` moves every offset
    but the first by that many rows (the planted fault)."""
    if case["kernel"] == "flash_attention":
        q, k, v = args
        t = q.shape[1] // n
        outs = []
        for i in range(n):
            q0 = i * t
            end = q0 + t
            outs.append(wrapper(q[:, q0:end].contiguous(),
                                k[:, :end].contiguous(),
                                v[:, :end].contiguous(), **kw,
                                q_offset=q0 + (fault if i else 0)))
        return torch.cat(outs, dim=1)
    q, ck, cv, pos = args
    rows = ck.shape[1] // n
    outs, lses = [], []
    for i in range(n):
        s0 = i * rows
        o, l = wrapper(q, ck[:, s0:s0 + rows].contiguous(),
                       cv[:, s0:s0 + rows].contiguous(), pos, **kw,
                       k_offset=s0 + (fault if i else 0), return_lse=True)
        outs.append(o)
        lses.append(l)
    return da_mod.combine_shards(torch.stack(outs), torch.stack(lses))


def check_shard_splits(chk: Checker, lm_kernels: dict, da_mod,
                       lm_times: dict, gen) -> dict:
    """Phase shard_splits: each case of ``shard_split_cases``, fp32 and bf16,
    split into 2, 4 and 8 shards through the kernels against the plain
    unsplit version (the lm_checks tolerance), the plain version split the
    same way against it too, and whether the bits equal the unsplit launch;
    every planted offset fault (one row off) must fail the check in fp32 or
    bf16 (in bf16 one key more or less among thousands can stay inside
    the tolerance of a long row; fp32's 1e-4 holds it).  Beside them, the
    times phase's flash and decode at zamba2's serving shapes (offset 0,
    bf16, cold L2) and their times before the offsets."""
    recs, caught = [], {}
    for ci, case in enumerate(shard_split_cases()):
        wrapper, plain = lm_kernels[case["kernel"]]
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = lm_operands(case, dtype, gen)
            whole = wrapper(*args, **kw)
            want = plain(*args, **kw)
            tol = _attn_tol(want, plain, args, kw)
            for n in SHARD_SPLITS:
                got = split_call(case, args, kw, n, wrapper, da_mod)
                chk.add(case["kernel"], {**case, "dtype": str(dtype)[6:],
                                         "shards": n}, got, want, 0, tol)
                rec = chk.cases[-1]
                plain_split = split_call(case, args, kw, n, plain, da_mod)
                perr = ((plain_split.float() - want.float()).abs()
                        / tol).max().item()
                rec.update(bits_equal_unsplit_launch=torch.equal(got, whole),
                           plain_split_err_over_tol=perr,
                           ok=rec["ok"] and perr <= 1.0)
                bad = split_call(case, args, kw, n, wrapper, da_mod, fault=1)
                ratio = ((bad.float() - want.float()).abs() / tol).max().item()
                rec["offset_fault_err_over_tol"] = ratio
                caught[ci, n] = caught.get((ci, n), False) or ratio > 1.0
                recs.append(rec)
            del args, whole, want
    torch.cuda.synchronize()
    timed = {k: {"ms": lm_times[k]["ms"], "before_offsets_ms": ms,
                 "ratio": lm_times[k]["ms"] / ms}
             for k, ms in BEFORE_OFFSETS_MS.items()}
    out = {"cases": len(recs), "failed": sum(not r["ok"] for r in recs),
           "bits_equal_unsplit_launch": sum(r["bits_equal_unsplit_launch"]
                                            for r in recs),
           "max_err_over_tol": max(r["err_over_tol"] for r in recs),
           "max_plain_split_err_over_tol": max(r["plain_split_err_over_tol"]
                                               for r in recs),
           "offset_faults": len(caught),
           "offset_faults_caught": sum(caught.values()),
           "offset0_bf16": timed}
    if out["failed"] or not all(caught.values()):
        raise SystemExit(f"shard_splits failed: {out}")
    return out


def build_with_faults(_build) -> tuple[float, dict]:
    """Phase 2: every source (``_build.build_all``) and, beside it, one nvcc
    per planted fault of ``PLANTED``, each building its source against a
    copy of csrc/ in a temporary directory with the one edit made.  Returns
    the main build's nvcc seconds and (name, source stem) -> the faulty
    library's path (in a directory that lives as long as the process)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_faults_"))
    atexit.register(shutil.rmtree, tmp, True)
    procs, libs = {}, {}
    try:
        for faults, edited, targets in PLANTED:
            text = (_build.CSRC / edited).read_text()
            for name, (old, new) in faults.items():
                if text.count(old) != 1:
                    raise SystemExit(f"planted fault {name}: its text is not "
                                     f"in csrc/{edited} exactly once")
                csrc = tmp / name
                shutil.copytree(_build.CSRC, csrc)
                (csrc / edited).write_text(text.replace(old, new))
                for target in targets:
                    key = (name, Path(target).stem)
                    tag = f"{name}_{key[1]}"
                    libs[key] = tmp / f"lib{tag}.so"
                    with open(tmp / f"{tag}.log", "w") as log:
                        procs[tag] = subprocess.Popen(
                            [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                             str(csrc), "-o", str(libs[key]),
                             str(csrc / target)],
                            stdout=log, stderr=subprocess.STDOUT)
        nvcc_s = _build.build_all()
        for tag, proc in procs.items():
            if proc.wait() != 0:
                log = (tmp / f"{tag}.log").read_text()
                raise SystemExit(f"planted fault {tag}: nvcc failed: "
                                 f"{log[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return nvcc_s, libs


def load_fault(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check_flash_faults(_build, fa_mod, libs: dict, gen) -> dict:
    """Each planted fault's library through the flash wrapper on the bf16
    flash cases of lm_kernel_cases, at their tolerance: how many cases
    fail and the worst err / tol.  Raises unless every fault fails one."""
    cases = [c for c in lm_kernel_cases() if c["kernel"] == "flash_attention"]
    plain = fa_mod.flash_attention_plain
    out = {}
    for name in FLASH_BF16_FAULTS:
        lib = load_fault(libs[name, "flash_attention"], fa_mod._SIGNATURES)
        chk = Checker()
        with mock.patch.object(_build, "load", lambda *_: lib):
            for case in cases:
                args, kw = lm_operands(case, torch.bfloat16, gen)
                want = plain(*args, **kw)
                chk.add("flash_attention", case,
                        fa_mod.flash_attention(*args, **kw), want,
                        case["dh"], _attn_tol(want, plain, args, kw))
        out[name] = {"cases_failed": len(chk.failures()), "of": len(cases),
                     "max_err_over_tol": max(c["err_over_tol"]
                                             for c in chk.cases),
                     "zamba2_case_err_over_tol": chk.cases[0]["err_over_tol"]}
    missed = [n for n, r in out.items() if not r["cases_failed"]]
    if missed:
        raise SystemExit(f"the bf16 flash checks miss planted faults "
                         f"{missed}: {out}")
    return out


def check_cnn_faults(kern, _build, libs: dict, calls: list, gen) -> dict:
    """Each CNN_FAULTS library pair through the conv2d and weight-stationary
    wrappers on their fp32 main-path shapes (the full epilogue), at the
    checks' tolerance: how many cases of each kernel fail and the worst
    err / tol.  Raises unless every fault fails a case, and unless the
    dropped split fails a weight-stationary case."""
    out = {}
    for name in CNN_FAULTS:
        faulty = {"conv2d": load_fault(libs[name, "conv2d"],
                                       kern.conv._SIGNATURES),
                  "matmul": load_fault(libs[name, "matmul"],
                                       kern.mm._SIGNATURES)}
        chk = Checker()
        with mock.patch.object(_build, "load", lambda lib, _: faulty[lib]):
            for c in calls:
                x_, w_, full = make_operands(kern, c, torch.float32, gen)
                ep = epilogue_of(full, True, True, True, True)
                chk.add(c["kernel"], {"x": c["x"], "w": c["w"]},
                        kern.run(c, x_, w_, ep), kern.plain(c, x_, w_, ep),
                        kern.reduction(c))
        torch.cuda.synchronize()
        out[name] = {}
        for kname in sorted({c["kernel"] for c in calls}):
            cs = [c for c in chk.cases if c["kernel"] == kname]
            out[name][kname] = {
                "cases_failed": sum(not c["ok"] for c in cs), "of": len(cs),
                "max_err_over_tol": max(c["err_over_tol"] for c in cs)}
    missed = [n for n, r in out.items()
              if not any(k["cases_failed"] for k in r.values())]
    if missed or not out["combine_drops_last_split"][
            "mm_weight_stationary"]["cases_failed"]:
        raise SystemExit(f"the fp32 conv2d and weight-stationary checks miss "
                         f"planted faults {missed}: {out}")
    return out


def lm_reduction(case: dict) -> int:
    return case["fl"] if case["kernel"] == "conv1d_causal" else case["dh"]


def check_lm_kernels(chk: Checker, lm_kernels: dict, gen) -> dict:
    """Every LM case, fp32 and bf16, against the plain version, and run
    twice for the same bits."""
    for case in lm_kernel_cases():
        wrapper, plain = lm_kernels[case["kernel"]]
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = lm_operands(case, dtype, gen)
            got, want = wrapper(*args, **kw), plain(*args, **kw)
            tol = (None if case["kernel"] == "conv1d_causal"
                   else _attn_tol(want, plain, args, kw))
            chk.add(case["kernel"], {**case, "dtype": str(dtype)[6:]}, got,
                    want, lm_reduction(case), tol)
            same = torch.equal(got, wrapper(*args, **kw))
            rec = chk.cases[-1]
            rec.update(repeat_identical=same, ok=rec["ok"] and same)
            del args, got, want
    torch.cuda.synchronize()
    summary = {}
    for kname in lm_kernels:
        cs = [c for c in chk.cases if c["kernel"] == kname]
        summary[kname] = {
            "cases": len(cs), "failed": sum(not c["ok"] for c in cs),
            "repeats_identical": all(c["repeat_identical"] for c in cs),
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
        if kname == "decode_attention":
            # a yardstick of the memory system, not a bound: a device copy
            # of the K cache moves as many bytes as decode reads (half read,
            # half written)
            rows[kname]["cache_copy_ms"] = cold_time_ms(args[1].clone, flush)
    return rows


def time_decode_paths(lm_kernels: dict, peaks: dict, flush, gen) -> dict:
    """Decode at the new paths' shapes (``decode_path_cases``), bf16, cold
    L2, at each case's positions, beside its bound (the rows its mask lets
    in), its plain version and SDPA with the same position mask (SDPA has
    no soft-cap: a yardstick of the shape)."""
    wrapper, plain = lm_kernels["decode_attention"]
    rows = {}
    for name, case in zip(DECODE_PATH_NAMES, decode_path_cases(),
                          strict=True):
        args, kw = lm_operands(case, torch.bfloat16, gen)
        flops, nbytes = lm_cost(case, torch.bfloat16, case["pos"])
        t_ops, t_bytes = flops / peaks["bf16"], nbytes / peaks["bw"]
        rows[name] = {
            "case": case, "kernel_pos": list(kernel_pos(case, case["pos"])),
            "max_abs_err": (wrapper(*args, **kw).float()
                            - plain(*args, **kw).float()).abs().max().item(),
            "ms": cold_time_ms(lambda: wrapper(*args, **kw), flush),
            "plain_ms": cold_time_ms(lambda: plain(*args, **kw), flush),
            "library_ms": cold_time_ms(lm_library(case, args), flush),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}
    return rows


# ------------------------------------------------------------- zamba2 ------
def forced_logits(lm, cfg, params, prompts, tokens, gen: int, *,
                  impl="auto", dtype=None) -> list:
    """fp32 logits (B, V) of the prefill's last position and of one decode
    step per column of ``tokens`` (B, n), each step fed that column (teacher
    forcing), so two engines meet the same inputs whatever their argmax;
    the cache is sized for ``gen`` tokens, as the served run's."""
    dtype = dtype or lm.COMPUTE_DTYPE
    b, t = tokens.shape[0], prompts["tokens"].shape[1]
    logits, cache = lm.prefill(cfg, params, prompts, t + gen, impl=impl,
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
            ns(decode_attention=lambda q, ck, cv, pos, **kw: real_da(
                q, ck, cv, pos - 1, **kw),
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
    """zamba2-2.7b served at full width and depth, Z_BATCH x Z_PROMPT-token
    prompts, Z_GEN tokens out, bf16 (``serve_path``): per prefill a conv1d
    launch per layer and a flash launch per group, per decode step a decode
    launch per group; the three planted faults of ``planted_faults``."""
    cfg, params = serve.load_model("zamba2-2.7b", device=DEVICE, seed=SEED)
    prompts = serve.make_prompts(cfg, Z_BATCH, Z_PROMPT, device=DEVICE,
                                 seed=SEED)
    return serve_path("zamba2", serve, lm, cfg, params, prompts, Z_GEN,
                      counters, {"conv1d_causal": cfg.n_layers,
                                 "flash_attention": cfg.n_groups},
                      {"decode_attention": cfg.n_groups},
                      planted_faults(attn_mod, fa_mod, da_mod, cfg.n_groups))


# ------------------------------------------------------- head dim 256 ------
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


def ptxas_instances(log: str, tag: str) -> dict:
    """Registers and spilled bytes of each kernel instance in one source's
    ``-Xptxas -v`` output whose mangled name holds ``tag``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if tag in m.group(1) else None
        elif name:
            rec = out.setdefault(name[:90], {})
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads")):
                hit = re.search(pat, line)
                if hit:
                    rec[key] = int(hit.group(1))
    return out


def dh256_library(case: dict, args):
    """SDPA at the same shape: causal, or masked to the window (it has no
    soft-cap, so it is a yardstick of the shape, not the same function)."""
    if case["kernel"] == "decode_attention" or not case["window"]:
        return lm_library(case, args)
    q, k, v = (a.transpose(1, 2) for a in args)
    i = torch.arange(case["t"], device=DEVICE)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                         - case["window"])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def check_dh256(_build, lm_kernels: dict, peaks: dict, flush, gen) -> dict:
    """Phase attn_dh256: flash and decode at gemma2's shapes against their
    plain versions in fp32 and bf16 (tolerances as lm_checks; decode twice,
    the same bits), the new instances' registers and spills (none may
    spill), and each kernel's bf16 time at the full shapes beside its
    bound, its plain version and SDPA."""
    chk = Checker()
    for case in dh256_cases():
        wrapper, plain = lm_kernels[case["kernel"]]
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = lm_operands(case, dtype, gen)
            got, want = wrapper(*args, **kw), plain(*args, **kw)
            chk.add(case["kernel"], {**case, "dtype": str(dtype)[6:]}, got,
                    want, case["dh"], _attn_tol(want, plain, args, kw))
            if case["kernel"] == "decode_attention":
                same = torch.equal(got, wrapper(*args, **kw))
                chk.cases[-1].update(repeat_identical=same,
                                     ok=chk.cases[-1]["ok"] and same)
            del args, got, want
    torch.cuda.synchronize()
    ptx = {n: ptxas_instances(_build.build_log(n), "Li256")
           for n in ("flash_attention", "decode_attention")}
    spills = [(n, k) for n, inst in ptx.items() for k, r in inst.items()
              if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    times = {}
    for case in dh256_cases()[:2] + dh256_cases()[-1:]:
        wrapper, plain = lm_kernels[case["kernel"]]
        pos = None
        if case["kernel"] == "decode_attention":
            pos = (case["s"] - 1,) * case["b"]
        args, kw = lm_operands(case, torch.bfloat16, gen, pos)
        flops, nbytes = lm_cost(case, torch.bfloat16, pos or ())
        t_ops, t_bytes = flops / peaks["bf16"], nbytes / peaks["bw"]
        name = (f"flash window {case['window']}"
                if case["kernel"] == "flash_attention" else "decode")
        times[name] = {
            "case": {**case, "pos": list(pos)} if pos else case,
            "max_abs_err": (wrapper(*args, **kw).float()
                            - plain(*args, **kw).float()).abs().max().item(),
            "ms": cold_time_ms(lambda: wrapper(*args, **kw), flush),
            "plain_ms": cold_time_ms(lambda: plain(*args, **kw), flush, 3),
            "library_ms": cold_time_ms(dh256_library(case, args), flush),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}
    rec = {"phase": "attn_dh256", "cases": len(chk.cases),
           "failed": chk.failures(),
           "max_err_over_tol": max(c["err_over_tol"] for c in chk.cases),
           "ptxas": ptx, "times_bf16": times,
           "tolerance": "as lm_checks",
           "library": "scaled_dot_product_attention (causal or window "
                      "mask, no soft-cap)"}
    emit(rec)
    if chk.failures() or spills:
        raise SystemExit(f"attn_dh256: {len(chk.failures())} checks failed "
                         f"({chk.failures()[:1]}); spilling instances "
                         f"{spills}")
    return rec


# ----------------------------------------------------- LM serving paths ------
def decode_faults(attn_mod, da_mod) -> dict:
    """The decode kernel called without its soft-cap (gemma2's decode)."""
    real_da = da_mod.decode_attention
    return {"decode_drops_softcap": (
        attn_mod, "_decode", types.SimpleNamespace(
            decode_attention=lambda q, ck, cv, pos, window=0, softcap=0.0:
                real_da(q, ck, cv, pos, window=window),
            decode_attention_plain=da_mod.decode_attention_plain))}


def ring_faults(lm, attn_mod) -> dict:
    """Wrong rolling-cache paths (mixtral), each a patch of a name the model
    looks up at call time: name -> (module, attribute, replacement).  (The
    kernel given the unclamped position is no fault: it bounds the position
    by S - 1 itself, which on a ring is W - 1.)"""
    real_ad, real_place = attn_mod.attention_decode, lm._place_kv

    def slot_as_position(params, x, ck, cv, pos, rolling_window=0, **kw):
        # a ring layer decoded as a linear cache at the slot: RoPE at
        # pos % W, and the window mask over slot indices
        if not rolling_window:
            return real_ad(params, x, ck, cv, pos, **kw)
        return real_ad(params, x, ck, cv, pos % rolling_window, **kw)

    def not_rolled(buf, kv):
        # the prompt's last W tokens in order, not at slot pos % W
        w, t = buf.shape[1], kv.shape[1]
        if t <= w:
            return real_place(buf, kv)
        buf.copy_(kv[:, t - w:])

    return {"ring_slot_as_position": (attn_mod, "attention_decode",
                                      slot_as_position),
            "ring_prefill_not_rolled": (lm, "_place_kv", not_rolled)}


def rwkv_faults(ssm_mod) -> dict:
    """RWKV-6's decode token shift without the carried row."""
    real = ssm_mod._token_shift
    return {"decode_token_shift_drops_carry": (
        ssm_mod, "_token_shift",
        lambda x, prev, mu, impl="auto": real(x, None, mu, impl))}


def weights_gb(params) -> float:
    """Bytes of every tensor in a nested dict (fp32 masters and copies)."""
    if isinstance(params, dict):
        return sum(weights_gb(v) for v in params.values())
    return params.numel() * params.element_size() / 2 ** 30


class RoutingReplay:
    """MoE routing held fixed across the bf16 engines of a logit check.

    Top-k routing is discontinuous: two correct engines whose bf16
    activations differ in the last bit can pick different experts for a
    token whose k-th and (k+1)-th router probabilities nearly tie, and that
    token's logits then move by O(1).  ``record()`` keeps the expert choices
    (``models.moe._top_k``) of one run, the plain fp32 engine's, and
    ``replay()`` hands them to another run call by call (the gates are that
    run's own probabilities at those experts), counting the choices that
    run would have made otherwise; ``replay(force=False)`` only counts, and
    the run routes on its own."""

    def __init__(self, moe_mod):
        self.moe, self.real = moe_mod, moe_mod._top_k
        self.choices: list = []
        self.flips = self.decisions = 0

    def record(self):
        self.choices = []

        def top_k(probs, k):
            vals, idx = self.real(probs, k)
            self.choices.append(idx)
            return vals, idx
        return mock.patch.object(self.moe, "_top_k", top_k)

    def replay(self, force: bool = True):
        it = iter(self.choices)
        self.flips = self.decisions = 0

        def top_k(probs, k):
            idx, (vals, own) = next(it), self.real(probs, k)
            self.flips += int((own.sort(-1).values != idx.sort(-1).values)
                              .any(-1).sum())
            self.decisions += idx[..., 0].numel()
            return (probs.gather(-1, idx), idx) if force else (vals, own)
        return mock.patch.object(self.moe, "_top_k", top_k)


def serve_path(name: str, serve, lm, cfg, params, prompts: dict, gen: int,
               counters: dict, want_prefill: dict, want_step: dict,
               faults: dict, *, compare: int = LM_COMPARE,
               timed: int = LM_TIMED) -> dict:
    """One LM served at full width through ``launch.serve``, as phase zamba2
    (module docstring): exact launches per prefill, per decode step and per
    run; the prefill's and the first LM_COMPARE - 1 decode steps' logits,
    teacher-forced, against the plain engine in bf16 (sqrt(2) x the plain
    bf16 engine's distance from plain fp32) and in fp32 (1e-3 x max(1,
    max|ref|)), where each planted fault must fail the fp32 check;
    host-clock medians, peak memory, and the device's busy time and idle
    share of a prefill and a decode step.  For an MoE arch the two bf16
    engines take the plain fp32 engine's expert choices (``RoutingReplay``),
    counting the tokens each would have routed otherwise; the fp32 kernel
    engine and the fault runs route on their own, and the fp32 kernel
    engine must choose as the plain fp32 engine did, token for token.
    ``compare`` and ``timed`` cut the teacher-forced decode steps compared
    and the served runs timed (phase perf_off)."""
    import contextlib
    from repro_torch.models import moe as moe_mod
    b, t = prompts["tokens"].shape
    max_seq = t + gen

    def counted(fn):
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items()}

    zero = {k: 0 for k in counters}
    want_prefill, want_step = {**zero, **want_prefill}, {**zero, **want_step}
    want_run = {k: want_prefill[k] + (gen - 1) * want_step[k]
                for k in counters}
    torch.cuda.reset_peak_memory_stats()
    # the main path, as a user runs it: prompts in, gen tokens out
    out, launches = counted(lambda: serve.generate(cfg, params, prompts,
                                                   gen))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    (logits, cache), per_prefill = counted(
        lambda: lm.prefill(cfg, params, prompts, max_seq=max_seq))
    step_batch = {"token": torch.argmax(logits[:, -1], dim=-1)[:, None],
                  "pos": torch.full((b,), t, dtype=torch.int32,
                                    device=DEVICE)}
    _, per_step = counted(lambda: lm.decode_step(cfg, params, step_batch,
                                                 cache))
    runs = [serve.generate(cfg, params, prompts, gen)
            for _ in range(timed)]

    # parity: every engine fed the main run's own tokens
    forced = out["tokens"][:, :compare]
    run = lambda **kw: forced_logits(lm, cfg, params, prompts, forced, gen,
                                     **kw)
    fp32 = torch.float32
    replay = RoutingReplay(moe_mod) if cfg.is_moe else None
    flips = {}
    with replay.record() if replay else contextlib.nullcontext():
        ref32 = run(impl="ref", dtype=fp32)
    engines = {}
    for key, kw in (("kernels_bf16", {}), ("plain_bf16", {"impl": "ref"}),
                    ("kernels_fp32", {"dtype": fp32})):
        with (replay.replay(force=key != "kernels_fp32") if replay
              else contextlib.nullcontext()):
            engines[key] = run(**kw)
        flips[key] = (replay.flips, replay.decisions) if replay else None
    got, ref, got32 = (engines[k] for k in ("kernels_bf16", "plain_bf16",
                                            "kernels_fp32"))
    dist = lambda a, b_: [(x - y).abs().max().item() for x, y in zip(a, b_)]
    errs, noise, errs32 = dist(got, ref), dist(ref, ref32), dist(got32, ref32)
    tols = [2 ** 0.5 * n for n in noise]
    tols32 = [1e-3 * max(1.0, r.abs().max().item()) for r in ref32]
    over = lambda es, ts: max(e / t_ for e, t_ in zip(es, ts))
    finite = all(bool(torch.isfinite(g).all()) for g in got + got32)
    fault_recs = {}
    for fname, (mod, attr, fn) in faults.items():
        with mock.patch.object(mod, attr, fn):
            fe = dist(run(dtype=fp32), ref32)
        fault_recs[fname] = {"fp32_max_abs_err": fe,
                             "fp32_max_err_over_tol": over(fe, tols32)}
    rec = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "weights_gb": weights_gb(params), "batch": b, "prompt_len": t,
           "gen": gen, "tokens_shape": list(out["tokens"].shape),
           "launches": launches, "expected_launches": want_run,
           "launches_per_prefill": per_prefill,
           "launches_per_decode_step": per_step,
           "prefill_ms_median": statistics.median(r["prefill_ms"]
                                                  for r in runs),
           "prefill_ms_all": [r["prefill_ms"] for r in runs],
           "decode_ms_per_token_median": statistics.median(
               x for r in runs for x in r["step_ms"]),
           "decode_ms_per_token_min": min(x for r in runs
                                          for x in r["step_ms"]),
           "logits_max_abs_err": errs, "logits_tol": tols,
           "max_err_over_tol": over(errs, tols),
           "plain_bf16_vs_fp32": noise,
           "kernels_bf16_vs_fp32": dist(got, ref32),
           "fp32_logits_max_abs_err": errs32, "fp32_logits_tol": tols32,
           "fp32_max_err_over_tol": over(errs32, tols32),
           "logits_max_abs_ref": [r.abs().max().item() for r in ref],
           "planted_faults": fault_recs, "finite": finite,
           "routing_replayed_in_bf16": bool(replay),
           "routing_flips_of_decisions": flips,
           "argmax_agreement": [(g.argmax(-1) == r.argmax(-1)).float()
                                .mean().item() for g, r in zip(got, ref)],
           "sample": out["tokens"][0, :12].tolist(),
           "peak_memory_gb": peak_gb,
           "decode_step_device": profile_busy(
               lambda: lm.decode_step(cfg, params, step_batch, cache)),
           "decode_step_host": host_profile(
               lambda: lm.decode_step(cfg, params, step_batch, cache), 3),
           "prefill_device": profile_busy(
               lambda: lm.prefill(cfg, params, prompts, max_seq=max_seq),
               reps=1)}
    emit(rec)
    for what, got_n, want_n in (("per prefill", per_prefill, want_prefill),
                                ("per decode step", per_step, want_step),
                                ("per run", launches, want_run)):
        if got_n != want_n:
            raise SystemExit(f"{name}: launches {what} {got_n} != {want_n}")
    if not finite or rec["max_err_over_tol"] > 1.0 or \
            rec["fp32_max_err_over_tol"] > 1.0:
        raise SystemExit(f"{name}: logits off the plain engine by {errs} "
                         f"in bf16, {errs32} in fp32 (tol {tols}, {tols32})")
    if replay and flips["kernels_fp32"][0]:
        raise SystemExit(f"{name}: the fp32 kernel engine routed "
                         f"{flips['kernels_fp32']} (flips, decisions) "
                         f"otherwise than the plain fp32 engine")
    missed = [f for f, r in fault_recs.items()
              if r["fp32_max_err_over_tol"] <= 1.0]
    if missed:
        raise SystemExit(f"{name}: the fp32 logit check misses planted "
                         f"faults {missed}")
    return rec


def cut_model(lm, arch: str, n_layers: int):
    """(config, parameters) of ``arch`` at full width with its depth cut to
    n_layers: random fp32 weights from SEED on the card, with their bf16
    compute copies."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import with_compute_copies
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    return cfg, with_compute_copies(lm.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE))


def run_gemma2(serve, lm, attn_mod, fa_mod, da_mod, counters: dict) -> dict:
    """gemma2-9b served at full width (d_model 3584, 16 heads of 256, vocab
    256000), G_LAYERS layers (two local on rings of 4096 slots, two global
    on linear caches; soft-cap 50), one G_PROMPT-token prompt, G_GEN tokens
    out, bf16 (``serve_path``): G_LAYERS flash launches per prefill and
    G_LAYERS decode launches per step; planted faults, half the window in
    the first of every two flash calls, and the decode kernel without its
    soft-cap."""
    cfg, params = cut_model(lm, "gemma2-9b", G_LAYERS)
    prompts = serve.make_prompts(cfg, 1, G_PROMPT, device=DEVICE, seed=SEED)
    faults = {k: v for k, v in planted_faults(attn_mod, fa_mod, da_mod,
                                              2).items()
              if k == "one_prefill_flash_half_window"}
    faults.update(decode_faults(attn_mod, da_mod))
    return serve_path("gemma2", serve, lm, cfg, params, prompts, G_GEN,
                      counters, {"flash_attention": cfg.n_layers},
                      {"decode_attention": cfg.n_layers}, faults)


def run_mixtral(serve, lm, attn_mod, counters: dict):
    """mixtral-8x7b served at full width (d_model 4096, 32 heads over 8 of
    128, d_ff 14336, 8 experts top-2, window 4096, vocab 32000), M_LAYERS
    layers, M_BATCH x M_PROMPT-token prompts (rings rolled at prefill and
    wrapped in decode), M_GEN tokens out, bf16 (``serve_path``): M_LAYERS
    flash launches per prefill and M_LAYERS decode launches per step;
    planted ring faults.  Returns the record, the config and the weights
    (the scheduler phase serves them too)."""
    cfg, params = cut_model(lm, "mixtral-8x7b", M_LAYERS)
    prompts = serve.make_prompts(cfg, M_BATCH, M_PROMPT, device=DEVICE,
                                 seed=SEED)
    rec = serve_path("mixtral", serve, lm, cfg, params, prompts, M_GEN,
                     counters, {"flash_attention": cfg.n_layers},
                     {"decode_attention": cfg.n_layers},
                     ring_faults(lm, attn_mod))
    return rec, cfg, params


def run_rwkv6(serve, lm, counters: dict) -> dict:
    """rwkv6-1.6b served at full width and depth (24 layers, 32 heads of 64,
    d_ff 7168, vocab 65536), R_BATCH x R_PROMPT-token prompts, R_GEN tokens
    out, bf16 (``serve_path``): two conv1d launches (the token shifts) per
    layer per prefill and per decode step; a planted fault, the decode
    token shift without its carried row."""
    from repro_torch.models import ssm as ssm_mod
    cfg, params = serve.load_model("rwkv6-1.6b", device=DEVICE, seed=SEED)
    prompts = serve.make_prompts(cfg, R_BATCH, R_PROMPT, device=DEVICE,
                                 seed=SEED)
    shifts = {"conv1d_causal": 2 * cfg.n_layers}
    return serve_path("rwkv6", serve, lm, cfg, params, prompts, R_GEN,
                      counters, shifts, shifts, rwkv_faults(ssm_mod))


def run_scheduler(lm, cfg, params, counters: dict) -> dict:
    """Phase scheduler: ``serving.ContinuousBatcher`` on mixtral's weights,
    S_SLOTS slots, S_REQUESTS requests whose prompt lengths and budgets are
    drawn from SEED (slots reused; rings rolled at admission or not, and
    wrapped at different positions per row).  The bf16 run (the main
    path): exact launches (M_LAYERS flash per admission, M_LAYERS decode per
    step), every request admitted once and completed once with its budget,
    the counters and the events agreeing, slot occupancy.  Then the same
    run in fp32 with the kernels and with ``impl="ref"``: every token
    equal; where one differs, its request, step and both runs' top-2 logit
    margins there are printed, and the phase fails."""
    from repro_torch.observability import events
    from repro_torch.serving import ContinuousBatcher, Request
    g = torch.Generator().manual_seed(SEED)
    lens = torch.randint(S_PROMPT_RANGE[0], S_PROMPT_RANGE[1] + 1,
                         (S_REQUESTS,), generator=g).tolist()
    budgets = torch.randint(S_BUDGET_RANGE[0], S_BUDGET_RANGE[1] + 1,
                            (S_REQUESTS,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).to(DEVICE)
               for n in lens]
    max_seq = S_PROMPT_RANGE[1] + S_BUDGET_RANGE[1]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sched_"))
    atexit.register(shutil.rmtree, tmp, True)

    def serve_all(tag, **kw):
        """(batcher, events, top-2 margins by (rid, token index), s)."""
        batcher = ContinuousBatcher(cfg, params, batch_slots=S_SLOTS,
                                    max_seq=max_seq, **kw)
        margins, real_pf, real_ds = {}, lm.prefill, lm.decode_step

        def margin(logits):
            top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            return (top[:, 0] - top[:, 1]).tolist()

        admitted = [0]

        def prefill(*a, **k):
            # admission is FIFO: the n-th prefill is request n's first token
            out = real_pf(*a, **k)
            margins[(admitted[0], 0)] = margin(out[0])[0]
            admitted[0] += 1
            return out

        def decode_step(*a, **k):
            out = real_ds(*a, **k)
            for slot, m in enumerate(margin(out[0])):
                r = batcher.slot_req[slot]
                if r is not None:
                    margins[(r.rid, len(r.generated))] = m
            return out

        path = tmp / f"{tag}.jsonl"
        events.install(str(path))
        try:
            for i, (p, n) in enumerate(zip(prompts, budgets)):
                batcher.submit(Request(rid=i, prompt=p, max_new_tokens=n))
            t0 = time.perf_counter()
            with mock.patch.object(lm, "prefill", prefill), \
                    mock.patch.object(lm, "decode_step", decode_step):
                batcher.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            events.uninstall()
        evs = [json.loads(line) for line in path.read_text().splitlines()]
        return batcher, evs, margins, secs

    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    main_b, evs, _, secs = serve_all("bf16")
    launches = {k: f.launches for k, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = main_b.stats()
    c = stats["counters"]
    want = {k: 0 for k in counters}
    want["flash_attention"] = cfg.n_layers * S_REQUESTS
    want["decode_attention"] = cfg.n_layers * int(c["decode_steps"])
    kinds = lambda k: sorted(e["rid"] for e in evs if e["kind"] == k)
    done = {r.rid: r for r in main_b.completed}
    problems = []
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    for k in ("scheduler.admit", "scheduler.complete", "scheduler.evict"):
        if kinds(k) != list(range(S_REQUESTS)):
            problems.append(f"{k} for requests {kinds(k)}")
    if sorted(done) != list(range(S_REQUESTS)) or any(
            len(done[i].generated) != budgets[i] for i in done):
        problems.append("requests not completed once each with their "
                        "budgets")
    emitted = sum(len(r.generated) for r in done.values())
    if (c["requests_admitted"], c["requests_completed"],
            c["tokens_generated"] + c["prefill_tokens_emitted"],
            c["prompt_tokens"]) != (S_REQUESTS, S_REQUESTS, emitted,
                                    sum(lens)):
        problems.append(f"counters {c} disagree with the requests")

    # fp32: the kernels against the plain engine, token for token
    b32, _, m32, _ = serve_all("fp32", dtype=torch.float32)
    bref, _, mref, _ = serve_all("fp32_ref", dtype=torch.float32,
                                 impl="ref")
    toks = lambda b_: {r.rid: r.generated for r in b_.completed}
    t32, tref = toks(b32), toks(bref)
    differ = []
    for rid in sorted(tref):
        k = next((i for i, (x, y) in enumerate(zip(t32[rid], tref[rid]))
                  if x != y), None)
        if k is not None:
            differ.append({"rid": rid, "token": k,
                           "margin_kernels": m32.get((rid, k)),
                           "margin_ref": mref.get((rid, k))})
    if differ:
        problems.append(f"fp32 tokens differ from impl='ref': {differ}")
    rec = {"phase": "scheduler", "arch": cfg.name, "slots": S_SLOTS,
           "prompt_lens": lens, "budgets": budgets, "max_seq": max_seq,
           "rings_rolled_at_admission": [n > cfg.window for n in lens],
           "launches": launches, "expected_launches": want,
           "counters": c, "slot_occupancy": stats["slot_occupancy"],
           "tokens_per_s": stats.get("tokens_per_s"),
           "latencies": stats["latencies"], "wall_s": secs,
           "completion_order": [r.rid for r in main_b.completed],
           "events": len(evs), "peak_memory_gb": peak_gb,
           "fp32_tokens_equal_ref": not differ, "fp32_differences": differ,
           "min_top2_margin_fp32_ref": min(mref.values())}
    emit(rec)
    if problems:
        raise SystemExit(f"scheduler: {problems}")
    return rec


# --------------------------------------------------------------- tune ------
def tuned_key(autotune, call: dict) -> str:
    """The tuning key of one main-path kernel call, its epilogue included."""
    if call["kernel"] == "conv2d":
        return autotune.conv2d_key(call["x"], call["w"], call["stride"],
                                   call["padding"], "float32",
                                   call["epilogue"])
    x, s = call["x"], call["stride"]
    rows = x[0] if len(x) == 2 else x[0] * -(-x[1] // s) * -(-x[2] // s)
    return autotune.gemm_key(rows, *call["w"], "float32", call["epilogue"])


def run_tune(kern, calls: dict, paths: dict, x, counters: dict,
             gen) -> dict:
    """Phase tune: tune every layer of ResNet-50 (dense and sparse) and of
    VGG-16 into a temporary user cache (``launch.tune``), then per network,
    with the tuner on: one counted forward, held to the untuned forward
    (1e-3 x max|untuned|); under the tracer every carla_conv and kernel
    span must carry its layer's entry (tuned=True, its tile); every
    main-path call timed (cold L2) under its tuned plan and under the
    analytic one, and its tuned output held to the plain version; forward
    medians with the tuner on and off.  A committed table must not be
    stale."""
    from repro_torch.core import autotune, carla
    from repro_torch.launch import tune
    from repro_torch.observability import trace
    stale = autotune.stale_tables()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    atexit.register(shutil.rmtree, tmp, True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = tmp
    t0 = time.perf_counter()
    entries, records = {}, {}
    for net, sparse in (("resnet50", True), ("vgg16", False)):
        e, r = tune.tune_layers(tune.net_layers(net, sparse))
        entries.update(e)
        records.update(r)
    tune_s = time.perf_counter() - t0
    autotune.save_user_cache(entries)
    autotune.reset()
    changed = {k: [records[k][0]["short"], e.config.short, e.default_ms,
                   e.tuned_ms]
               for k, e in entries.items() if e.config != records[k][0][
                   "config"]}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    per_net, problems = {}, []
    autotune.enable()
    try:
        for p, d in paths.items():
            apply, params, kw = d["apply"], d["params"], d["kw"]
            for f in counters.values():
                f.launches = 0
            out = apply(params, x, **kw)
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in counters.items()}
            autotune.disable()
            untuned = apply(params, x, **kw)
            autotune.enable()
            err = (out - untuned).abs().max().item()
            tol = 1e-3 * untuned.abs().max().item()
            with trace.capture() as tr:
                apply(params, x, **kw)
            spans = tr.find("carla_conv")
            untagged = []
            for sp in spans:
                a = sp.attrs
                plan = carla.plan_conv(tuple(a["x_shape"]),
                                       tuple(a["w_shape"]), a["stride"],
                                       a["padding"], epilogue_tag=a[
                                           "epilogue"])
                child = sp.children[0].attrs
                want = (plan.tile_config.short
                        if plan.tile_config is not None else None)
                if want is None or not (a["tuned"] and child["tuned"]
                                        and a["tile_config"] == want
                                        == child["tile_config"]):
                    untagged.append([a["layer"], want, a["tile_config"],
                                     child["tile_config"]])
            chk = Checker()
            sums = {"default_ms": 0.0, "tuned_ms": 0.0}
            for c in calls[p]:
                x_, w_, full = make_operands(kern, c, torch.float32, gen)
                ep = model_epilogue(full, c["epilogue"])
                tiles = autotune.lookup(tuned_key(autotune, c)).config
                chk.add(c["kernel"], {"x": c["x"], "w": c["w"],
                                      "tiles": tiles.short},
                        kern.run_tuned(c, x_, w_, ep, tiles),
                        kern.plain(c, x_, w_, ep), kern.reduction(c))
                sums["default_ms"] += cold_time_ms(
                    lambda: kern.run(c, x_, w_, ep), flush)
                sums["tuned_ms"] += cold_time_ms(
                    lambda: kern.run_tuned(c, x_, w_, ep, tiles), flush)
            fwd = {}
            for on in (True, False):
                (autotune.enable if on else autotune.disable)()
                ts = []
                for _ in range(FWD_REPS):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    apply(params, x, **kw)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t1) * 1e3)
                fwd["tuned" if on else "untuned"] = statistics.median(ts)
            autotune.enable()
            per_net[p] = {
                "launches": launches, "max_abs_err_vs_untuned": err,
                "tol": tol, "spans": len(spans), "spans_not_tuned": untagged,
                "kernel_sum_cold_l2": sums, "tuned_calls_failed":
                    chk.failures(), "forward_median_ms": fwd}
            cnn_launches = sum(v for k, v in launches.items()
                               if k in kern.wrappers)
            if (err > tol or untagged or chk.failures()
                    or cnn_launches != len(calls[p])
                    or any(launches[k] for k in launches
                           if k not in kern.wrappers)):
                problems.append(p)
    finally:
        autotune.disable()
        autotune.reset()
        del os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    rec = {"phase": "tune", "keys": len(entries), "tune_seconds": tune_s,
           "changed_plan": len(changed), "changed": changed,
           "committed_tables_stale": stale, "per_net": per_net}
    emit(rec)
    if problems or stale:
        raise SystemExit(f"tune: tuned forwards off for {problems}; stale "
                         f"committed tables {stale}")
    return {**rec, "records": {k: [{f: r[f] for f in ("short", "ok",
                                                       "err_over_tol",
                                                       "rounds")}
                                   for r in rs]
                               for k, rs in records.items()}}


# ------------------------------------------------------------- report ------
def run_report(cnn, params, x, peaks: dict) -> dict:
    """Phase report: the planned-vs-measured table (paper Table II) of one
    traced ResNet-50 forward, utilisation against the card's fp32 peak;
    its Chrome trace written to a temporary file must parse, with one
    complete event per span."""
    from repro_torch.observability import export, report, trace
    with trace.capture() as tr:
        cnn.resnet50_apply(params, x)
    rows = report.reconcile(tr.spans, peak_gflops=peaks["fp32"] / 1e9)
    table = report.format_table(rows)
    path = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_")) / "trace.json"
    atexit.register(shutil.rmtree, path.parent, True)
    export.export_chrome_trace(tr.spans, str(path))
    doc = json.loads(path.read_text())
    n_spans = sum(1 for root in tr.spans for _ in root.walk())
    n_complete = sum(e["ph"] == "X" for e in doc["traceEvents"])
    print(table, flush=True)
    rec = {"phase": "report", "rows": len(rows),
           "totals": report.totals(rows), "spans": n_spans,
           "complete_events": n_complete,
           "trace_events": len(doc["traceEvents"]),
           "measured": "host wall time per dispatch up to "
                       "torch.cuda.synchronize; util% against the fp32 "
                       "peak"}
    emit(rec)
    if n_complete != n_spans or len(rows) != 53:
        raise SystemExit(f"report: {n_complete} complete events for "
                         f"{n_spans} spans, {len(rows)} rows")
    return {**rec, "table": table}


# ---------------------------------------------------------------- training --
def train_kernel_cases() -> list[dict]:
    """The two kernels on the training path at training shapes: flash at
    smollm-360m's heads (dh 64, 15 over 5) with T past two backward blocks,
    at zamba2's (dh 80, 32 over 32) with T past FLASH_REF_ROWS, one
    windowed, soft-capped case, and at the two training paths' own shapes
    (``train_flash_cases``: smollm's B 8 x T 4096, where the plain
    gradient, not cut into the backward's row blocks, keeps about 6 GB of
    fp32 scores a saved tensor, and zamba2's B 2 x T 2048); conv1d at zamba2's Mamba2 conv (FL 4, a column slice of the
    in_proj output) and RWKV-6's token shift (FL 2)."""
    return [flash_case(2, 1100, 15, 5, 64), flash_case(1, 2100, 32, 32, 80),
            flash_case(1, 1500, 8, 2, 64, window=700, softcap=30.0),
            *train_flash_cases(),
            conv1d_case(2, 2048, 5248, 4, row=10448, col0=5120),
            conv1d_case(2, 2048, 2048, 2)]


def _train_tol(want: torch.Tensor) -> float:
    """The stated gradient tolerance (phase train_kernels)."""
    scale = max(1.0, want.float().abs().max().item())
    return (1e-4 if want.dtype != torch.bfloat16 else 2.0 ** -6) * scale


def _grads(fn, args, kw, g) -> tuple:
    """(output, the gradient of every input) of fn under the cotangent g."""
    ins = [a.detach().requires_grad_() for a in args]
    out = fn(*ins, **kw)
    return out, torch.autograd.grad(out, ins, g)


def drop_last_kv_head_dv(fa_mod):
    """The planted backward fault: dv of the last KV head zeroed."""
    real = fa_mod.flash_attention_grads

    def faulty(*a, **kw):
        dq, dk, dv = real(*a, **kw)
        dv = dv.clone()
        dv[:, :, -1] = 0
        return dq, dk, dv
    return faulty


def drop_last_tap_dw(c1_mod):
    """A planted conv1d backward fault: dw of the newest tap zeroed."""
    real = c1_mod.conv1d_causal_grads

    def faulty(*a, **kw):
        dx, dw = real(*a, **kw)
        dw = dw.clone()
        dw[-1] = 0
        return dx, dw
    return faulty


def check_train_kernels(fa_mod, c1_mod, gen) -> dict:
    """Phase train_kernels: each autograd Function at ``train_kernel_cases``,
    fp32 and bf16.  The forward must equal the kernel's own launch bit for
    bit; the gradients of every input under a random cotangent must match
    autograd through the plain version, run in one piece (tolerance
    ``_train_tol``); the planted fault (dv of the last KV head zeroed) must
    fail the flash cases."""
    funcs = {"flash_attention": (fa_mod.flash_attention,
                                 fa_mod.flash_attention_plain,
                                 lambda a, kw: fa_mod._launch(
                                     *a, kw["window"], kw["softcap"])),
             "conv1d_causal": (c1_mod.conv1d_causal,
                               c1_mod.conv1d_causal_plain,
                               lambda a, kw: c1_mod._launch(*a))}
    cases, faults = [], []
    for case in train_kernel_cases():
        fn, plain, launch = funcs[case["kernel"]]
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = lm_operands(case, dtype, gen)
            g = torch.randn(args[0].shape, device=DEVICE,
                            generator=gen).to(dtype)      # out's shape
            out, got = _grads(fn, args, kw, g)
            with torch.no_grad():
                own = launch(args, kw)
            ref, want = _grads(plain, args, kw, g)
            ratio = max(((a.float() - w.float()).abs().max().item()
                         / _train_tol(w)) for a, w in zip(got, want))
            rec = {**case, "dtype": str(dtype)[6:],
                   "forward_equals_launch": torch.equal(out, own),
                   "forward_max_abs_err_vs_plain":
                       (out.float() - ref.float()).abs().max().item(),
                   "grad_max_abs_err": [(a.float() - w.float()).abs().max()
                                        .item() for a, w in zip(got, want)],
                   "grad_tol": [_train_tol(w) for w in want],
                   "grad_err_over_tol": ratio,
                   "grads_bit_equal": all(torch.equal(a, w)
                                          for a, w in zip(got, want))}
            if case["kernel"] == "flash_attention":
                with mock.patch.object(fa_mod, "flash_attention_grads",
                                       drop_last_kv_head_dv(fa_mod)):
                    _, bad = _grads(fn, args, kw, g)
                rec["fault_err_over_tol"] = max(
                    ((a.float() - w.float()).abs().max().item()
                     / _train_tol(w)) for a, w in zip(bad, want))
                faults.append(rec["fault_err_over_tol"])
            rec["ok"] = (rec["forward_equals_launch"] and ratio <= 1.0
                         and rec.get("fault_err_over_tol", 2.0) > 1.0)
            cases.append(rec)
            del args, out, got, ref, want, g
    torch.cuda.synchronize()
    rec = {"phase": "train_kernels",
           "tolerance": "gradients fp32 1e-4 x max(1, max|ref|), bf16 2^-6 "
                        "x max(1, max|ref|); forward equal to the launch",
           "cases": len(cases), "failed": sum(not c["ok"] for c in cases),
           "max_grad_err_over_tol": max(c["grad_err_over_tol"]
                                        for c in cases),
           "grads_bit_equal": sum(c["grads_bit_equal"] for c in cases),
           "fault_min_err_over_tol": min(faults), "per_case": cases}
    emit(rec)
    if rec["failed"]:
        raise SystemExit(f"train_kernels: {rec['failed']} cases failed: "
                         f"{[c for c in cases if not c['ok']][:1]}")
    return rec


def wiring_gate(lm, cfg, batch: dict, faults: dict) -> dict:
    """The fp32 wiring gate: random weights from SEED, fp32 activations,
    the kernel engine's loss and every gradient leaf (its autograd
    Functions) within 1e-3 x max(1, max|ref|) of ``impl="ref"`` (autograd
    through the plain versions) on the card; each planted fault (name ->
    (module, attribute, replacement)) must fail it."""
    from repro_torch.pytree import flatten
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = lm.init_params(cfg, gen, device=DEVICE)
    leaves = flatten(params)[0]
    for p in leaves:
        p.requires_grad_(True)

    def loss_and_grads(impl):
        loss = lm.loss_fn(cfg, params, batch, impl=impl, dtype=torch.float32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    ref_loss, ref_g = loss_and_grads("ref")
    tols = [1e-3 * max(1.0, g.abs().max().item()) for g in ref_g]
    loss_tol = 1e-3 * max(1.0, abs(ref_loss.item()))

    def over(loss, grads) -> float:
        return max([abs(loss.item() - ref_loss.item()) / loss_tol]
                   + [(g - r).abs().max().item() / t
                      for g, r, t in zip(grads, ref_g, tols)])

    loss, grads = loss_and_grads("auto")
    rec = {"loss": loss.item(), "ref_loss": ref_loss.item(),
           "leaves": len(leaves), "err_over_tol": over(loss, grads),
           "faults": {}}
    for name, (mod, attr, fn) in faults.items():
        with mock.patch.object(mod, attr, fn):
            rec["faults"][name] = over(*loss_and_grads("auto"))
    rec["ok"] = (rec["err_over_tol"] <= 1.0
                 and all(v > 1.0 for v in rec["faults"].values()))
    del params, leaves, grads, ref_g
    return rec


def train_flops(cfg, params, b: int, t: int) -> float:
    """Model FLOPs of one training step: 6 x the matmul parameters (every
    leaf of two or more dims; a tied table counts once, as the head) x the
    tokens, plus attention, 3 x its forward's 4 x dh FLOPs per causal
    (query, key) pair per head."""
    from repro_torch.pytree import flatten
    n = sum(p.numel() for p in flatten(params)[0] if p.ndim >= 2)
    n_attn = cfg.n_layers if cfg.block_type == "attn" else \
        cfg.n_groups * bool(cfg.hybrid_attn_period)
    pairs = t * (t + 1) // 2
    return 6.0 * n * b * t + 3 * 4 * cfg.d_head * cfg.n_heads * b * pairs \
        * n_attn


def time_cuda_ms(fn, reps: int = 3) -> float:
    """Mean CUDA-event time of fn over reps calls, after one warm call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def counted_step(mk, counters: dict, dev):
    """(step_fn for the supervisor, its record): each step moves its batch
    to the card, trains with every launch count set to 0 just before, and
    waits for the loss; the record keeps each step's launch counts and the
    newest state."""
    from repro_torch.data import to_device
    record = {"launches": [], "state": None}

    def step_fn(state, batch):
        for f in counters.values():
            f.launches = 0
        state, metrics = mk["fn"](state, to_device(batch, dev))
        metrics = {"loss": metrics["loss"].item(),
                   "step": int(metrics["step"])}
        record["launches"].append({k: f.launches
                                   for k, f in counters.items()})
        record["state"] = state
        return state, metrics
    return step_fn, record


def run_train_smollm(lm, fa_mod, counters: dict, peaks: dict) -> dict:
    """Phase train_smollm: smollm-360m trained at full width and depth
    (module docstring)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import (PrefetchIterator, SyntheticTokenDataset,
                                  to_device)
    from repro_torch.launch import steps
    from repro_torch.pytree import flatten
    from repro_torch.runtime import TrainSupervisor
    cfg = get_config("smollm-360m")
    ds = SyntheticTokenDataset(cfg.vocab, TS_SEQ, TS_BATCH, seed=SEED)
    l_gate, b_gate, t_gate = TS_GATE
    gate_batch = to_device(SyntheticTokenDataset(
        cfg.vocab, t_gate, b_gate, seed=SEED).batch(0), DEVICE)
    gate = wiring_gate(lm, dataclasses.replace(cfg, n_layers=l_gate),
                       gate_batch, {"dv_of_last_kv_head_zeroed": (
                           fa_mod, "flash_attention_grads",
                           drop_last_kv_head_dv(fa_mod))})
    free()
    mk = steps.make_train_step(cfg, "adamw", TS_LR, device=DEVICE)
    init = mk["make_init"](SEED)
    first = to_device(ds.batch(0), DEVICE)
    with torch.no_grad():                       # the bf16 loss gate
        p0 = init()["params"]
        l_kern = lm.loss_fn(cfg, p0, first).item()
        l_bf16 = lm.loss_fn(cfg, p0, first, impl="ref").item()
        l_fp32 = lm.loss_fn(cfg, p0, first, impl="ref",
                            dtype=torch.float32).item()
        del p0
    free()
    bf16_gate = {"kernels_bf16": l_kern, "plain_bf16": l_bf16,
                 "plain_fp32": l_fp32,
                 "err": abs(l_kern - l_fp32),
                 "tol": 2 ** 0.5 * abs(l_bf16 - l_fp32) + 1e-3}
    ckpt_dir = HERE / "chiprun_out" / "train_smollm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        sup = TrainSupervisor(str(ckpt_dir), ckpt_every=TS_CKPT_EVERY)
        state, start, cursor = sup.restore_or_init(init, None)
        step_fn, record = counted_step(mk, counters, DEVICE)
        losses, dts, saved = [], [], {}

        def cb(step, metrics, dt):
            losses.append(metrics["loss"])
            dts.append(dt)
            if step + 1 == TS_CKPT_EVERY:        # what the checkpoint holds
                saved["leaves"] = [x.detach().cpu().clone()
                                   for x in flatten(record["state"])[0]]

        it = PrefetchIterator(ds, start_index=cursor)
        t0 = time.perf_counter()
        state, last, _ = sup.run(state, step_fn, it, start, TS_STEPS, cb)
        run_s = time.perf_counter() - t0
        it.close()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # a fresh supervisor restores step TS_CKPT_EVERY and runs on
        shutil.rmtree(ckpt_dir / f"step_{TS_STEPS:08d}")
        t0 = time.perf_counter()
        sup2 = TrainSupervisor(str(ckpt_dir), ckpt_every=10 ** 9)
        state2, start2, cursor2 = sup2.restore_or_init(None, state)
        restore_s = time.perf_counter() - t0
        restored_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
            flatten(state2)[0], saved["leaves"]))
        del saved
        resumed = []
        step_fn2, _ = counted_step(mk, counters, DEVICE)
        it2 = PrefetchIterator(ds, start_index=cursor2)
        sup2.run(state2, step_fn2, it2, start2, TS_STEPS,
                 lambda s, m, dt: resumed.append(m["loss"]))
        it2.close()
        del state2
        free()
        batch = to_device(ds.batch(TS_STEPS), DEVICE)
        attn_args = [torch.randn((TS_BATCH, TS_SEQ, h, cfg.d_head),
                                 device=DEVICE).to(torch.bfloat16)
                     for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
        attn_bwd_ms = time_cuda_ms(lambda: fa_mod.flash_attention_grads(
            *attn_args, torch.randn_like(attn_args[0])), reps=2)
        del attn_args
        prof = profile_busy(lambda: mk["fn"](state, batch), reps=1, top=12)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    step_ms = statistics.median(dts[1:]) * 1e3
    flops = train_flops(cfg, state["params"], TS_BATCH, TS_SEQ)
    want = {k: 0 for k in counters}
    want["flash_attention"] = 2 * cfg.n_layers
    rec = {"phase": "train_smollm", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "batch": TS_BATCH, "seq_len": TS_SEQ,
           "params_m": sum(p.numel() for p in flatten(state["params"])[0])
           / 1e6,
           "wiring_gate_fp32": gate, "bf16_loss_gate": bf16_gate,
           "losses": losses, "resumed_losses": resumed,
           "resumed_bit_equal": resumed == losses[TS_CKPT_EVERY:],
           "restored_bit_equal": restored_equal, "cursor": cursor2,
           "start": start2, "step_ms_all": [d * 1e3 for d in dts],
           "step_ms_median_2_to_6": step_ms,
           "tokens_per_s": TS_BATCH * TS_SEQ / step_ms * 1e3,
           "run_s": run_s, "restore_s": restore_s,
           "peak_memory_gb": peak_gb,
           "launches_per_step": record["launches"],
           "expected_launches_per_step": want,
           "model_tflop_per_step": flops / 1e12,
           "model_tflops": flops / step_ms / 1e9,
           "h100_sxm_dense_bf16_peak_tflops": peaks["bf16"] / 1e12,
           "attention_backward_ms_per_layer": attn_bwd_ms,
           "attention_backward_ms_per_step": attn_bwd_ms * cfg.n_layers,
           "step_device": prof}
    emit(rec)
    lnv = math.log(cfg.vocab)
    problems = []
    if any(c != want for c in record["launches"]):
        problems.append(f"launches per step {record['launches']} != {want}")
    if not all(math.isfinite(x) for x in losses + resumed):
        problems.append(f"losses not finite: {losses} {resumed}")
    if abs(losses[0] - lnv) > 0.5:
        problems.append(f"step 1's loss {losses[0]} not within 0.5 of "
                        f"ln V = {lnv}")
    if not statistics.mean(losses[-2:]) < losses[0]:
        problems.append(f"the loss did not fall: {losses}")
    if not (restored_equal and cursor2 == TS_CKPT_EVERY
            and start2 == TS_CKPT_EVERY and rec["resumed_bit_equal"]):
        problems.append("the resume check failed")
    if not gate["ok"]:
        problems.append(f"fp32 wiring gate: {gate}")
    if not bf16_gate["err"] <= bf16_gate["tol"]:
        problems.append(f"bf16 loss gate: {bf16_gate}")
    if problems:
        raise SystemExit(f"train_smollm: {problems}")
    return rec


def run_train_zamba2(lm, c1_mod, counters: dict) -> dict:
    """Phase train_zamba2: zamba2-2.7b at full width, TZ_LAYERS layers (one
    group: 6 Mamba2 blocks and the shared attention block), TZ_BATCH x
    TZ_SEQ, TZ_STEPS AdamW steps with the plain SSD scan inside."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset, to_device
    from repro_torch.launch import steps
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=TZ_LAYERS)
    b_gate, t_gate = TZ_GATE
    gate = wiring_gate(lm, cfg, to_device(SyntheticTokenDataset(
        cfg.vocab, t_gate, b_gate, seed=SEED).batch(0), DEVICE),
        {"dw_of_newest_tap_zeroed": (c1_mod, "conv1d_causal_grads",
                                     drop_last_tap_dw(c1_mod))})
    free()
    ds = SyntheticTokenDataset(cfg.vocab, TZ_SEQ, TZ_BATCH, seed=SEED)
    mk = steps.make_train_step(cfg, "adamw", TS_LR, device=DEVICE)
    state = mk["make_init"](SEED)()
    step_fn, record = counted_step(mk, counters, DEVICE)
    per_step = record["launches"]
    losses, dts = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TZ_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, ds.batch(i))
        dts.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    want = {k: 0 for k in counters}
    want.update(conv1d_causal=2 * cfg.n_layers,
                flash_attention=2 * cfg.n_groups)
    rec = {"phase": "train_zamba2", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": TZ_BATCH, "seq_len": TZ_SEQ, "losses": losses,
           "step_ms_all": dts, "launches_per_step": per_step,
           "expected_launches_per_step": want,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "wiring_gate_fp32": gate}
    emit(rec)
    del state
    free()
    if any(c != want for c in per_step) or \
            not all(math.isfinite(x) for x in losses) or not gate["ok"]:
        raise SystemExit(f"train_zamba2: launches {per_step} (want {want}),"
                         f" losses {losses}, wiring gate {gate}")
    return rec


# ------------------------------------------------------------ sharded ------
def sharded_forced_logits(pre, dec, placed, prompts, tokens, gen: int) -> list:
    """``forced_logits`` through the sharded prefill and decode steps."""
    b, t = tokens.shape[0], prompts["tokens"].shape[1]
    logits, cache = pre["fn"](placed, prompts)
    out = [logits.full_tensor()[:, -1].float()]
    for i in range(tokens.shape[1]):
        step = {"token": tokens[:, i:i + 1],
                "pos": torch.full((b,), t + i, dtype=torch.int32,
                                  device=DEVICE)}
        logits, cache = dec["fn"](placed, cache, step)
        out.append(logits.full_tensor()[:, -1].float())
    return out


def run_sharded(serve, lm, counters: dict, zamba2: dict,
                train_s: dict) -> dict:
    """Phase sharded (module docstring): the sharded steps on a (1, 1) mesh
    over a one-process NCCL group, zamba2 served and smollm-360m trained at
    full width and depth, beside the unsharded phases."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset, to_device
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.layers import COMPUTE_COPY_KEYS

    def masters(tree):
        return {k: masters(v) if isinstance(v, dict) else v
                for k, v in tree.items() if k not in COMPUTE_COPY_KEYS}

    def counted(fn):
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items()}

    store_dir = tempfile.mkdtemp(prefix="chip_smoke_store_")
    cuda = torch.device(DEVICE).type == "cuda"
    dist.init_process_group(
        "nccl" if cuda else "gloo", store=dist.FileStore(
            os.path.join(store_dir, "store"), 1), rank=0, world_size=1,
        **({"device_id": torch.device(DEVICE, 0)} if cuda else {}))
    try:
        mesh = make_smoke_mesh(device_type=torch.device(DEVICE).type)
        # zamba2-2.7b served: the same weights and prompts as phase zamba2
        t0 = time.perf_counter()
        cfg, params = serve.load_model("zamba2-2.7b", device=DEVICE,
                                       seed=SEED)
        prompts = serve.make_prompts(cfg, Z_BATCH, Z_PROMPT, device=DEVICE,
                                     seed=SEED)
        max_seq = Z_PROMPT + Z_GEN
        pre = steps.make_prefill(cfg, mesh, max_seq)
        dec = steps.make_decode_step(cfg, mesh, max_seq, Z_BATCH)
        placed = sharding.distribute(masters(params), mesh,
                                     dec["param_spec"])
        zero = {k: 0 for k in counters}
        want_pre = {**zero, "conv1d_causal": cfg.n_layers,
                    "flash_attention": cfg.n_groups}
        want_step = {**zero, "decode_attention": cfg.n_groups}
        (logits, cache), per_prefill = counted(
            lambda: pre["fn"](placed, prompts))
        step_batch = {"token": torch.argmax(logits.full_tensor()[:, -1],
                                            dim=-1)[:, None],
                      "pos": torch.full((Z_BATCH,), Z_PROMPT,
                                        dtype=torch.int32, device=DEVICE)}
        _, per_step = counted(lambda: dec["fn"](placed, cache, step_batch))
        out, per_run = counted(lambda: serve.generate_sharded(
            cfg, masters(params), prompts, Z_GEN, mesh))
        want_run = {k: want_pre[k] + (Z_GEN - 1) * want_step[k]
                    for k in counters}
        runs = [serve.generate_sharded(cfg, masters(params), prompts, Z_GEN,
                                       mesh) for _ in range(2)]
        forced = out["tokens"][:, :LM_COMPARE]
        got = sharded_forced_logits(pre, dec, placed, prompts, forced, Z_GEN)
        ref = forced_logits(lm, cfg, params, prompts, forced, Z_GEN)
        diffs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
        tol = min(zamba2["logits_tol"])
        _, cache = pre["fn"](placed, prompts)
        serve_rec = {
            "launches_per_prefill": per_prefill,
            "launches_per_decode_step": per_step, "launches_per_run": per_run,
            "logits_max_abs_diff": diffs, "logits_tol": tol,
            "logits_bit_equal": all(torch.equal(g, r)
                                    for g, r in zip(got, ref)),
            "tokens_equal_unsharded_sample":
                out["tokens"][0, :12].tolist() == zamba2["sample"],
            "prefill_ms_median": statistics.median(r["prefill_ms"]
                                                   for r in runs),
            "decode_ms_per_token_median": statistics.median(
                x for r in runs for x in r["step_ms"]),
            "unsharded_prefill_ms_median": zamba2["prefill_ms_median"],
            "unsharded_decode_ms_per_token_median":
                zamba2["decode_ms_per_token_median"],
            "decode_step_device": profile_busy(
                lambda: dec["fn"](placed, cache, step_batch)),
            "unsharded_decode_step_device": zamba2["decode_step_device"],
            "decode_step_host": host_profile(
                lambda: dec["fn"](placed, cache, step_batch), 3),
            "prefill_device": profile_busy(
                lambda: pre["fn"](placed, prompts), reps=1),
            "unsharded_prefill_device": zamba2["prefill_device"]}
        del params, placed, cache, logits, pre, dec, out, runs, got, ref
        free()
        serve_s = time.perf_counter() - t0

        # smollm-360m trained: the batches and initial state of train_smollm
        t0 = time.perf_counter()
        tcfg = get_config("smollm-360m")
        ds = SyntheticTokenDataset(tcfg.vocab, TS_SEQ, TS_BATCH, seed=SEED)
        mk = steps.make_train_step(tcfg, "adamw", TS_LR, mesh=mesh,
                                   device=DEVICE)
        state = mk["make_init"](SEED)()
        losses, launches, dts = [], [], []
        was_deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for i in range(SH_TRAIN_STEPS):
                batch = to_device(ds.batch(i), DEVICE)
                torch.cuda.synchronize()
                ts = time.perf_counter()
                (state, m), n = counted(lambda: mk["fn"](state, batch))
                losses.append(m["loss"].item())
                dts.append(time.perf_counter() - ts)
                launches.append(n)
            step_device = profile_busy(lambda: mk["fn"](state, batch),
                                       reps=1, top=8)
        finally:
            torch.use_deterministic_algorithms(was_deterministic)
        del state, mk
        free()
        want_train = {**zero, "flash_attention": 2 * tcfg.n_layers}
        ref_losses = train_s["losses"][:SH_TRAIN_STEPS]
        train_rec = {
            "losses": losses, "unsharded_losses": ref_losses,
            "loss_max_abs_diff": max(abs(a - b)
                                     for a, b in zip(losses, ref_losses)),
            "losses_bit_equal": losses == ref_losses,
            "launches_per_step": launches,
            "step_ms_all": [d * 1e3 for d in dts],
            "step_ms_median_2_on": statistics.median(dts[1:]) * 1e3,
            "unsharded_step_ms_median_2_to_6":
                train_s["step_ms_median_2_to_6"],
            "step_device": step_device,
            "unsharded_step_device": train_s["step_device"]}
        train_s_ = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    rec = {"phase": "sharded", "mesh": "(1, 1) data x model, NCCL, world 1",
           "zamba2_serve": serve_rec, "smollm_train": train_rec,
           "serve_seconds": serve_s, "train_seconds": train_s_}
    emit(rec)
    problems = []
    for what, got_n, want_n in (
            ("per prefill", per_prefill, want_pre),
            ("per decode step", per_step, want_step),
            ("per run", per_run, want_run)):
        if got_n != want_n:
            problems.append(f"zamba2 launches {what} {got_n} != {want_n}")
    if max(diffs) > tol:
        problems.append(f"zamba2 logits off the unsharded path by {diffs} "
                        f"(tol {tol})")
    if any(n != want_train for n in launches):
        problems.append(f"smollm launches per step {launches}")
    if not all(math.isfinite(x) for x in losses) or \
            train_rec["loss_max_abs_diff"] > 1e-4 * max(map(abs, ref_losses)):
        problems.append(f"smollm losses {losses} vs {ref_losses}")
    if problems:
        raise SystemExit(f"sharded: {problems}")
    return rec


def local_cache_bytes(lm, cfg, batch: int, max_seq: int) -> int:
    """Bytes of the sliding-window layers' KV caches of ``lm.init_cache``
    under the flags in force (shapes only: meta tensors)."""
    cache = lm.init_cache(cfg, batch, max_seq, device="meta")
    specs = lm._group_templates(cfg)
    return sum(v.numel() * v.element_size()
               for p, spec in enumerate(specs)
               if spec["kind"] == "attn" and spec["is_local"]
               for v in cache[f"p{p}"].values())


def beside(rec: dict, base: dict) -> dict:
    """A served path's headline numbers under the baseline flags beside the
    same path's under the default flags (its phase's record)."""
    keys = {"prefill_ms": ("prefill_ms_median",),
            "decode_ms_per_token": ("decode_ms_per_token_median",),
            "prefill_busy_ms": ("prefill_device", "device_busy_ms"),
            "prefill_idle": ("prefill_device", "idle_share"),
            "decode_busy_ms": ("decode_step_device", "device_busy_ms"),
            "decode_idle": ("decode_step_device", "idle_share"),
            "peak_gb": ("peak_memory_gb",)}
    out = {}
    for k, path in keys.items():
        pair = []
        for r in (rec, base):
            v = r
            for f in path:
                v = v.get(f) if isinstance(v, dict) else None
            pair.append(v)
        out[k] = {"baseline": pair[0], "default": pair[1]}
    out["launches"] = {"prefill": rec["launches_per_prefill"],
                       "decode_step": rec.get("launches_per_decode_step")}
    return out


def run_rwkv_per_token(serve, lm, counters: dict, base: dict) -> dict:
    """rwkv6-1.6b's prefill with the per-token WKV (``rwkv_chunked`` off) at
    full width and depth, R_BATCH x R_PROMPT: exact launches (48 conv1d, as
    the chunked form), its host-clock time, peak memory, and its logits'
    distance from the chunked form's (printed); the device's busy time and
    idle share of the per-token and the chunked prefill at R_BATCH x
    PO_RWKV_PROFILE_T (the profiler's trace of the whole per-token prefill,
    2048 x 24 steps of a few kernels each, takes minutes to read), device
    activity only; the fp32 wiring gate at PO_RWKV_GATE (batch, T): the
    kernel engine's prefill logits within 1e-3 x max(1, max|ref|) of
    ``impl="ref"``'s."""
    from repro_torch import perf
    cfg, params = serve.load_model("rwkv6-1.6b", device=DEVICE, seed=SEED)
    prompts = serve.make_prompts(cfg, R_BATCH, R_PROMPT, device=DEVICE,
                                 seed=SEED)
    max_seq = R_PROMPT + R_GEN
    cut = {"tokens": prompts["tokens"][:, :PO_RWKV_PROFILE_T]}
    prefill_cut = lambda: lm.prefill(cfg, params, cut,
                                      max_seq=PO_RWKV_PROFILE_T)
    chunked, _ = lm.prefill(cfg, params, prompts, max_seq=max_seq)
    busy_chunked = profile_busy(prefill_cut, reps=1, cpu=False)
    with perf.flags(rwkv_chunked=False):
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = lm.prefill(cfg, params, prompts, max_seq=max_seq)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: f.launches for k, f in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = profile_busy(prefill_cut, reps=1, cpu=False)
        gb, gt = PO_RWKV_GATE
        small = {"tokens": prompts["tokens"][:gb, :gt]}
        f32 = torch.float32
        got32, _ = lm.prefill(cfg, params, small, max_seq=gt, dtype=f32)
        ref32, _ = lm.prefill(cfg, params, small, max_seq=gt, impl="ref",
                              dtype=f32)
    err32 = (got32 - ref32).abs().max().item()
    tol32 = 1e-3 * max(1.0, ref32.abs().max().item())
    want = {**{k: 0 for k in counters}, **base["launches_per_prefill"]}
    finite = bool(torch.isfinite(logits).all())
    rec = {"prefill_ms": {"baseline": ms,
                          "default": base["prefill_ms_median"]},
           "peak_gb": {"baseline": peak_gb,
                       "default": base["peak_memory_gb"]},
           f"prefill_busy_ms_at_T{PO_RWKV_PROFILE_T}": {
               "baseline": busy.get("device_busy_ms"),
               "default": busy_chunked.get("device_busy_ms")},
           f"prefill_idle_at_T{PO_RWKV_PROFILE_T}": {
               "baseline": busy.get("idle_share"),
               "default": busy_chunked.get("idle_share")},
           "default_prefill_busy_ms": base["prefill_device"].get(
               "device_busy_ms"),
           "launches": {"prefill": launches, "decode_step": None},
           "finite": finite,
           "vs_chunked_bf16_max_abs": (logits.float() - chunked.float())
           .abs().max().item(),
           "fp32_gate": {"shape": PO_RWKV_GATE, "max_abs_err": err32,
                         "tol": tol32}}
    if launches != want:
        raise SystemExit(f"perf_off rwkv6: launches per prefill {launches} "
                         f"!= {want}")
    if not finite or err32 > tol32:
        raise SystemExit(f"perf_off rwkv6: per-token prefill logits "
                         f"finite={finite}, fp32 gate {err32} > {tol32}")
    return rec


def run_perf_off(serve, lm, counters: dict, base: dict, smi: str) -> dict:
    """Phase perf_off (module docstring): each flag's paper-faithful off path
    served at a path's full width, beside the same path's phase under the
    default flags (``base``: phase name -> record)."""
    from repro_torch import perf
    t_all = time.perf_counter()
    out, secs = {}, {}

    def launches_of(name):
        return (base[name]["launches_per_prefill"],
                base[name]["launches_per_decode_step"])

    t0 = time.perf_counter()
    with perf.baseline():
        cfg, params = cut_model(lm, "gemma2-9b", G_LAYERS)
        prompts = serve.make_prompts(cfg, 1, G_PROMPT, device=DEVICE,
                                     seed=SEED)
        rec = serve_path("perf_off gemma2", serve, lm, cfg, params, prompts,
                         G_GEN, counters, *launches_of("gemma2"), {})
        local = local_cache_bytes(lm, cfg, 1, G_PROMPT + G_GEN)
    local_default = local_cache_bytes(lm, cfg, 1, G_PROMPT + G_GEN)
    out["gemma2 baseline()"] = {
        **beside(rec, base["gemma2"]),
        "local_cache_bytes": {"baseline": local, "default": local_default},
        "max_err_over_tol": rec["max_err_over_tol"],
        "fp32_max_err_over_tol": rec["fp32_max_err_over_tol"]}
    del params
    free()
    secs["gemma2"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with perf.flags(bf16_attn_io=False):
        cfg, params = serve.load_model("zamba2-2.7b", device=DEVICE,
                                       seed=SEED)
        prompts = serve.make_prompts(cfg, Z_BATCH, Z_PROMPT, device=DEVICE,
                                     seed=SEED)
        rec = serve_path("perf_off zamba2", serve, lm, cfg, params, prompts,
                         Z_GEN, counters, *launches_of("zamba2"), {},
                         compare=PO_COMPARE, timed=PO_TIMED)
    out["zamba2 bf16_attn_io=False"] = {
        **beside(rec, base["zamba2"]),
        "max_err_over_tol": rec["max_err_over_tol"],
        "fp32_max_err_over_tol": rec["fp32_max_err_over_tol"]}
    del params
    free()
    secs["zamba2"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["rwkv6 rwkv_chunked=False"] = run_rwkv_per_token(serve, lm, counters,
                                                         base["rwkv6"])
    free()
    secs["rwkv6"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, params = cut_model(lm, "mixtral-8x7b", M_LAYERS)
    prompts = serve.make_prompts(cfg, M_BATCH, M_PROMPT, device=DEVICE,
                                 seed=SEED)
    default, _ = lm.prefill(cfg, params, prompts, max_seq=M_PROMPT + M_GEN)
    with perf.flags(bf16_moe_dispatch=False):
        rec = serve_path("perf_off mixtral", serve, lm, cfg, params, prompts,
                         M_GEN, counters, *launches_of("mixtral"), {},
                         compare=0, timed=PO_TIMED)
        fp32_combine, _ = lm.prefill(cfg, params, prompts,
                                     max_seq=M_PROMPT + M_GEN)
    out["mixtral bf16_moe_dispatch=False"] = {
        **beside(rec, base["mixtral"]),
        "max_err_over_tol": rec["max_err_over_tol"],
        "fp32_max_err_over_tol": rec["fp32_max_err_over_tol"],
        "prefill_logits_bit_equal_to_default": torch.equal(default,
                                                           fp32_combine)}
    del default, fp32_combine
    del params
    free()
    secs["mixtral"] = time.perf_counter() - t0
    summary = {"phase": "perf_off", "card": smi, "paths": out,
               "seconds_by_path": secs,
               "seconds": time.perf_counter() - t_all}
    emit(summary)
    return summary


def free() -> None:
    """Hand a finished phase's memory back before the next."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


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
    import dataclasses
    from repro_torch import perf
    # every phase but perf_off runs the default flags, whatever REPRO_PERF
    # says; perf_off sets its own inside
    perf.set_flags(**dataclasses.asdict(perf.PerfConfig()))
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
          "cuda": torch.version.cuda, "peaks": peaks,
          "perf_flags": dataclasses.asdict(perf.get())})
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build (and the planted faults' builds beside it)
    t0 = time.perf_counter()
    nvcc_s, fault_libs = build_with_faults(_build)
    ptxas = {src.stem: [line.strip()
                        for line in _build.build_log(src.stem).splitlines()
                        if "registers" in line or "spill" in line]
             for src in _build.sources()}
    emit({"phase": "build", "nvcc_seconds": nvcc_s,
          "seconds": time.perf_counter() - t0,
          "ptxas": {n: ptxas_summary(lines) for n, lines in ptxas.items()},
          "tensor_core_sass": {
              src.stem: tensor_core_counts(_build.build_dir()
                                           / f"lib{src.stem}.so")
              for src in _build.sources()}})

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
                                      "offset": c.get("offset", 0),
                                      "dtype": str(dtype)[6:],
                                      "epilogue": combo,
                                      "plan": kern.plan(c, x_, w_, ep)},
                        got, want, kern.reduction(c))
                same = torch.equal(got, kern.run(c, x_, w_, ep))
                rec = chk.cases[-1]
                rec.update(repeat_identical=same, ok=rec["ok"] and same)
    torch.cuda.synchronize()
    summary, missing = {}, []
    for kname in kern.wrappers:
        cs = [c for c in chk.cases if c["kernel"] == kname]
        summary[kname] = {
            "cases": len(cs), "failed": sum(not c["ok"] for c in cs),
            "repeats_identical": all(c["repeat_identical"] for c in cs),
            "max_err_over_tol": max(c["err_over_tol"] for c in cs),
            "max_abs_err_fp32": max(c["max_abs_err"] for c in cs
                                    if c["dtype"] == "float32"),
            "max_abs_err_bf16": max(c["max_abs_err"] for c in cs
                                    if c["dtype"] == "bfloat16")}
        for d in ("float32", "bfloat16"):
            plans = [c["plan"] for c in cs if c["dtype"] == d]
            seen = ({p["path"] for p in plans}
                    | {"split" if p["splits"] > 1 else "unsplit"
                       for p in plans})
            summary[kname][f"covered_{d}"] = sorted(seen)
            missing += [f"{kname} {d} {want}" for want in
                        ("vec16", "general", "split", "unsplit")
                        if want not in seen]
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
    if chk.failures() or missing:
        dump(details)
        raise SystemExit(f"{len(chk.failures())} kernel checks failed, "
                         f"first: {chk.failures()[:1]}; paths not covered: "
                         f"{missing}")
    t0 = time.perf_counter()
    fault_calls = [c for c in unique.values()
                   if c["kernel"] in ("conv2d", "mm_weight_stationary")]
    emit({"phase": "cnn_faults",
          **check_cnn_faults(kern, _build, fault_libs, fault_calls, dgen),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "flash_bf16_faults",
          **check_flash_faults(_build, fa_mod, fault_libs, dgen),
          "seconds": time.perf_counter() - t0})
    train_k = check_train_kernels(fa_mod, c1_mod, dgen)

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
            if c["kernel"] == "mm_weight_stationary":
                rows[-1]["device_kernels"] = device_kernels(
                    lambda: kern.run(c, x_, w_, ep))
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
    # the fixed time of one launch under this clock: a one-block kernel
    # that adds 1 to 256 floats, timed as every kernel above
    tiny = torch.zeros(256, device="cuda")
    launch_floor_ms = cold_time_ms(lambda: tiny.add_(1), flush)
    emit({"phase": "times", "path": "launch floor",
          "trivial_kernel_ms": launch_floor_ms})
    for p in ("resnet50", "resnet50_sparse"):
        emit({"phase": "times", "path": f"{p} weight-stationary calls",
              "launch_floor_ms": launch_floor_ms,
              "calls": [{**{f: r[f] for f in ("x", "w", "stride", "ms",
                                              "bound_ms", "device_kernels")},
                         "above_floor_ms": r["ms"] - launch_floor_ms}
                        for r in per_path[p]
                        if r["kernel"] == "mm_weight_stationary"]})
    many = [(r["x"], r["w"], r["device_kernels"])
            for rows in per_path.values() for r in rows
            if r.get("device_kernels", 1) != 1]
    if many:
        raise SystemExit(f"weight-stationary calls that ran other than one "
                         f"device kernel: {many}")
    lm_times = time_lm_kernels(lm_kernels, peaks, flush, dgen)
    emit({"phase": "times", "path": "zamba2 kernels, bf16, one call each",
          **{k: {f: r[f] for f in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "max_abs_err",
                                    "cache_copy_ms") if f in r}
             for k, r in lm_times.items()}})
    t0 = time.perf_counter()
    splits = check_shard_splits(Checker(), lm_kernels, da_mod, lm_times, dgen)
    emit({"phase": "shard_splits", **splits,
          "seconds": time.perf_counter() - t0})
    dh256 = check_dh256(_build, lm_kernels, peaks, flush, dgen)
    decode_paths = time_decode_paths(lm_kernels, peaks, flush, dgen)
    emit({"phase": "times", "path": "decode at the mixtral and gemma2 "
                                    "shapes, bf16, one call each",
          **{k: {f: r[f] for f in ("kernel_pos", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by",
                                    "max_abs_err")}
             for k, r in decode_paths.items()}})

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
    tuned = run_tune(kern, calls, paths, x, counters, dgen)
    table2 = run_report(cnn, r50, x, peaks)
    zamba2 = run_zamba2(serve, lm, attn_mod, fa_mod, da_mod, counters)
    free()
    gemma2 = run_gemma2(serve, lm, attn_mod, fa_mod, da_mod, counters)
    free()
    mixtral, m_cfg, m_params = run_mixtral(serve, lm, attn_mod, counters)
    sched = run_scheduler(lm, m_cfg, m_params, counters)
    del m_params
    free()
    rwkv6 = run_rwkv6(serve, lm, counters)
    free()
    t0 = time.perf_counter()
    train_s = run_train_smollm(lm, fa_mod, counters, peaks)
    free()
    emit({"phase": "train_smollm", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    train_z = run_train_zamba2(lm, c1_mod, counters)
    emit({"phase": "train_zamba2", "seconds": time.perf_counter() - t0})
    free()
    t0 = time.perf_counter()
    sharded = run_sharded(serve, lm, counters, zamba2, train_s)
    emit({"phase": "sharded", "seconds": time.perf_counter() - t0})
    free()
    perf_off = run_perf_off(serve, lm, counters,
                            {"zamba2": zamba2, "gemma2": gemma2,
                             "mixtral": mixtral, "rwkv6": rwkv6}, smi)

    dump({**details, "times": per_path, "lm_times": lm_times,
          "launch_floor_ms": launch_floor_ms,
          "models": models, "zamba2": zamba2, "attn_dh256": dh256,
          "decode_paths": decode_paths, "gemma2": gemma2,
          "mixtral": mixtral, "scheduler": sched, "rwkv6": rwkv6,
          "tune": tuned, "report": table2, "train_kernels": train_k,
          "train_smollm": train_s, "train_zamba2": train_z,
          "shard_splits": splits, "sharded": sharded, "perf_off": perf_off})

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
    for p, r in (("gemma2", gemma2), ("mixtral", mixtral),
                 ("rwkv6", rwkv6)):
        by_path[f"{p}_prefill"] = r["launches_per_prefill"]
        by_path[f"{p}_decode"] = r["launches_per_decode_step"]
    by_path["scheduler"] = sched["launches"]
    by_path["smollm_train_step"] = train_s["launches_per_step"][0]
    by_path["zamba2_train_step"] = train_z["launches_per_step"][0]
    zs = sharded["zamba2_serve"]
    by_path["sharded_zamba2_prefill"] = zs["launches_per_prefill"]
    by_path["sharded_zamba2_decode"] = zs["launches_per_decode_step"]
    by_path["sharded_smollm_train_step"] = \
        sharded["smollm_train"]["launches_per_step"][0]
    by_path.update({f"{p}_tuned": r["launches"]
                    for p, r in tuned["per_net"].items()})
    for name, r in perf_off["paths"].items():
        for what, n in r["launches"].items():
            if n is not None:
                by_path[f"perf_off_{name.split()[0]}_{what}"] = n
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
    dh256_rows = {"flash_attention": dh256["times_bf16"]["flash window 0"],
                  "decode_attention": dh256["times_bf16"]["decode"]}
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
                                    if k != "kernel"}),
            **({"gemma2_dh256": {f: dh256_rows[kname][f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}} if kname in dh256_rows else {}),
            **({"paths": {n: {f: r_[f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")} for n, r_ in decode_paths.items()}}
               if kname == "decode_attention" else {})})
    emit({"kernels": line})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
