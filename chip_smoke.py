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
             on the tensor cores; each of the three bf16 wide flash
             instances (dh above 256) must hold HMMA.  Then one wide
             decode call at its timed shape (dh 512, B 4, 8 heads over 4)
             under the profiler, in a process of its own, whose trace
             gives the launch's grid: it
             must be B x KH x splits blocks (one per kv head), not B x H x
             splits (one per query head).
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
             input; dh 20, padded to 64 in the wrappers; the paths no
             config has: conv1d at FL 1, 5, 7 and 9 (odd C, strided and
             contiguous x) and at the runtime-FL kernel's edges (T over
             several 128-step tiles and off them, T below FL, FL 65, 128,
             129 and 300 past one chunk of taps, odd C, a strided view,
             FL 7 at zamba2's prefill shape) and flash and decode at dh
             272, 301, 384, 512,
             1024 and 2048 (the wide kernels: GQA, windows, soft-caps,
             query and key offsets, a position per row, rings, the
             log-sum-exp, a cache of one row, groups of 16 and 18 heads)),
             and at the other
             LM paths' main-path shapes: mixtral's
             prefill flash (T 5120 past its window of 4096), decode at the
             mixtral, scheduler (B 4, a position per row) and gemma2
             serving shapes, rwkv6's token shifts in prefill and decode
             (FL 2, C 2048); fp32 and bf16.  Every case runs twice and must
             give the same bits (for decode: the combine's fixed order, the
             ticket counters' reset), and its first call must add one to
             its kernel's launch counter.  Decode's log-sum-exp within 1e-4
             x max(1, |plain|) of the plain version's (-inf where no row is
             visible, on both sides).
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
             tolerance, must fail on every one, and a dropped split (the
             L2's or a cluster's) on a weight-stationary case.
   flash_bf16_faults — the bf16 flash kernel shares no code with the fp32
             one that the zamba2 wiring check runs, so faults are planted
             in its source (``FLASH_BF16_FAULTS``: text edits of
             csrc/flash_attention.cu, each built apart in a temporary
             directory, in parallel with phase 2) and the bf16 flash cases
             above, at the same tolerance, must fail on every one: three in
             flash_mma_kernel, two in the wide kernel (a dh slice of the
             scores left out, a column slice of the output not rescaled).
   decode_wide_faults — the same for the wide decode kernel
             (``DECODE_WIDE_FAULTS``: a head of the group scored with
             another head's q), through the bf16 wide-head decode cases.
   conv1d_any_faults — the same for conv1d's runtime-FL kernel
             (``CONV1D_ANY_FAULTS``: the halo rows before a slab's tile
             left zero, the last chunk of taps skipped, a tap's weights
             taken from the neighbouring channel vector), through the
             any-FL cases whose FL no template instance takes, fp32 and
             bf16.
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
             changed plan; and the CLI with ``repro``'s options
             (``--net smoke --batch 2 --reps 2 --candidates 3 --out``),
             whose table must hold exactly the smoke net's batch-2 keys.  A
             committed table (kernels/tuned/) must not be stale.
   bench   — (before tune) the bench record at full size
             (``repro_torch.bench.telemetry_report.collect_bench`` over
             ``bench.run``'s networks: ResNet-50 and VGG-16 unfused and
             fused, ResNet-50's structured-sparse twin, the smoke sets;
             per layer the median cold-L2 CUDA-event time of 10 dispatches,
             the committed tuned tables on); hard gates: every fused block
             touches strictly fewer bytes than unfused, every pruned layer
             strictly fewer than its dense twin; then
             ``bench.check_regression`` against the committed BENCH_21.json,
             whose verdict and worst ratio are printed (a timing miss alone
             does not fail this run: the card may be another H100 at other
             clocks; the CLI is where the timing gate is hard).
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
   smollm_dh20 — (after rwkv6) smollm-360m's smoke config (2 layers,
             d_model 60, 3 heads over 1 of dh 20, which neither attention
             kernel is built at: the wrappers zero-pad q, k and v to 64 and
             keep dh 20's scale) served through ``launch.serve`` as phase
             zamba2 (``serve_path``: launches, the bf16 and fp32 logit
             gates, the three planted faults), 2 x 64-token prompts, 16
             out; decode's log-sum-exp at dh 20 within 1e-4 of the plain
             version's.  Its flash and decode calls are also lm_checks
             cases; after it both are timed in bf16 beside the same
             launch on operands padded beforehand (the same bits
             required) and the pads alone: the padding's cost.
   wide_paths — (after smollm_dh20) the paths no config has, served
             through ``launch.serve`` as phase zamba2 (``serve_path``:
             launches, the bf16 and fp32 logit gates, the three planted
             faults), 2 x 64-token prompts, 16 out: gemma2-9b's smoke config
             with 4 heads over 2 of dh 512 (the wide flash and decode
             kernels; local layers on rings of 16, soft-cap 50), and
             zamba2-2.7b's smoke config with d_conv 7 (conv1d's runtime-FL
             kernel).  Then flash and decode at dh 512 (8 heads over 4, T
             and S 2048) and conv1d at FL 7 (zamba2's prefill shape) in
             bf16, cold L2, beside the bound, the plain version and SDPA /
             depthwise F.conv1d, and in fp32; a device copy of decode's
             K cache, as many bytes as decode reads, and two of conv1d's
             input (the column slice into a contiguous tensor, and a
             contiguous one cloned); the wide and runtime-FL instances'
             registers and spills (none may spill), and the wide decode
             launch's grid that phase build read.  Beside the wide decode
             kernel, in turns, its yardsticks (``DECODE_WIDE_VARIANTS``,
             built with the planted faults): the ring of bulk copies
             alone, and the one instance of 8 heads at groups of 2 and 1;
             beside conv1d's runtime-FL kernel, in bf16 and fp32, its
             (``CONV1D_ANY_VARIANTS``): the slabs' copies and stores
             alone, and one tile a block (the same bits required).
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
The case lists, operands, costs and library calls are
``repro_torch.bench.kernel_bench``'s and the timer is ``bench.timer``'s (the
kernel bench CLI times the same rows).

7. the ``kernels`` line (the six kernels at their main paths' shapes, and
   the wide attention paths and conv1d at FL 7 at phase wide_paths' timed
   shapes, launched by its served runs), the card, and the last line
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
# the port's package, from the checkout this script sits in (alone, the
# import below fails and the script exits nonzero)
sys.path.insert(0, str(HERE / "src"))
from repro_torch.bench.kernel_bench import (  # noqa: E402
    DECODE_PATH_NAMES, G_GEN, G_PROMPT, M_BATCH, M_GEN, M_PROMPT, R_BATCH,
    R_PROMPT, S_BUDGET_RANGE, S_PROMPT_RANGE, S_SLOTS, SD_BATCH, SD_GEN,
    SD_PROMPT, TS_BATCH, TS_SEQ, TZ_BATCH, TZ_SEQ, Z_BATCH, Z_GEN, Z_PROMPT,
    Kernels, any_fl_cases, conv1d_case, conv1d_with, decode_case,
    decode_path_cases, dh20_cases,
    dh256_cases, epilogue_of, flash_case, kernel_pos, lm_kernel_cases,
    WIDE_DH, lm_operands, lm_reduction, main_path_shapes, make_operands,
    model_epilogue, peaks_for, time_cnn_call, time_lm_case, time_padding,
    train_flash_cases, wide_time_cases)
from repro_torch.bench.timer import cold_time_ms, flush_buffer  # noqa: E402

DEVICE = "cuda"
SEED = 0
FWD_REPS = 20
PROFILE_REPS = 5
# Shapes the kernel cases share live in repro_torch.bench.kernel_bench;
# these are the phases' own.  gemma2-9b serving at full width: 4 of its 42
# layers (two local, two global)
G_LAYERS = 4
# mixtral-8x7b serving at full width: 4 of its 32 layers
M_LAYERS = 4
# rwkv6-1.6b serving at full width and depth: 32 tokens out
R_GEN = 32
# the continuous-batching scheduler on mixtral's weights: 8 requests
S_REQUESTS = 8
# smollm-360m trained at full width and depth: 6 steps through the
# supervisor with a checkpoint every 3 at AdamW lr 3e-4, then steps 4-6
# again from the step-3 checkpoint; its fp32 wiring gate at (layers,
# batch, seq)
TS_STEPS, TS_CKPT_EVERY, TS_LR = 6, 3, 3e-4
TS_GATE = (2, 2, 1024)
# zamba2-2.7b trained at full width, depth cut to one group (6 Mamba2 blocks
# and the shared attention block), 3 steps; its fp32 wiring gate at (batch,
# seq)
TZ_LAYERS, TZ_STEPS = 6, 3
TZ_GATE = (1, 512)
# phase bench: the committed bench record it compares with
BASELINE = "BENCH_21.json"
# shard_splits: shards a sequence or a cache is cut into, and the cold-L2
# bf16 times of flash and decode at zamba2's serving shapes before the
# kernels took shard offsets (PERF.md §6)
SHARD_SPLITS = (2, 4, 8)
BEFORE_OFFSETS_MS = {"flash_attention": 0.3628, "decode_attention": 0.0503}
# phase sharded: smollm-360m's sharded train steps (train_smollm's first)
SH_TRAIN_STEPS = 3
# wide_paths: gemma2's smoke config at head dim WIDE_DH and zamba2's at
# d_conv WP_FL served at WP_BATCH x WP_PROMPT-token prompts, WP_GEN out
WP_FL, WP_BATCH, WP_PROMPT, WP_GEN = 7, 2, 64, 16
# LM paths: positions compared with the plain engine (the prefill's last
# and the first decode steps'), host-clock runs timed
LM_COMPARE, LM_TIMED = 8, 3
# perf_off: decode steps compared and served runs timed on the zamba2 and
# mixtral baselines (gemma2 keeps LM_COMPARE and LM_TIMED); the prompt
# length at which rwkv6's per-token and chunked prefills are profiled, and
# its fp32 wiring gate at (batch, T)
PO_COMPARE, PO_TIMED = 2, 1
PO_RWKV_PROFILE_T, PO_RWKV_GATE = 256, (1, 256)
# Faults planted in the bf16 flash kernels (flash_mma_kernel and, above dh
# 256, flash_wide_mma_kernel), name -> (text of csrc/flash_attention.cu, its
# replacement); the bf16 flash cases must catch each.  The first two touch
# only rows from 1024 on, which only the zamba2-shaped case has: long rows,
# where one key or one tile moves the output least.  The last two touch
# only the wide kernel, which the wide-head cases reach.
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
    # the wide kernel's scores leave out the last warp's slice of dh
    "wide_skips_a_dh_slice_of_s": (
        "      for (int j = 1; j < CS; ++j) {",
        "      for (int j = 1; j < CS - 1; ++j) {"),
    # the last column slice of the wide kernel's output keeps its old scale
    "wide_column_slice_not_rescaled": (
        "        o[d][2 * r] *= alpha;\n        o[d][2 * r + 1] *= alpha;\n",
        "        if (cs != CS - 1) o[d][2 * r] *= alpha;\n"
        "        if (cs != CS - 1) o[d][2 * r + 1] *= alpha;\n"),
}
# Faults planted in the wide decode kernel (decode_wide_kernel), name ->
# (text of csrc/decode_attention.cu, its replacement); the wide-head decode
# cases (bf16) must catch each.
DECODE_WIDE_FAULTS = {
    # the group's second head is scored with the first head's q
    "wide_decode_head_scored_with_another_q": (
        "*reinterpret_cast<const float4*>(qs + g * DP + c * VEC + e4);",
        "*reinterpret_cast<const float4*>(qs + (g == 1 ? 0 : g) * DP + "
        "c * VEC + e4);"),
}
# Faults planted in conv1d's runtime-FL kernel (conv1d_any_kernel), name ->
# (text of csrc/conv1d.cu, its replacement); the any-FL cases of lm_checks
# (``any_fl_cases``, FL other than 1-4, fp32 and bf16) must catch each.
CONV1D_ANY_FAULTS = {
    # each slab's rows before its tile (the FL - 1 steps of halo) left zero
    "conv1d_any_halo_left_zero": (
        "    const bool ok = t >= 0 && t < s.T && c < s.C;\n",
        "    const bool ok = t >= 0 && t < s.T && c < s.C &&\n"
        "                    (RING || j >= j1 - C1A_TB);\n"),
    # the last chunk of taps skipped when FL exceeds one slab's chunk
    "conv1d_any_last_chunk_skipped": (
        "    const int r_end = min(FL, (k + 1) * C1A_FC);\n",
        "    const int r_end = k + 1 < nch ? min(FL, (k + 1) * C1A_FC)\n"
        "                                  : k * C1A_FC;\n"),
    # tap r's weights taken from the neighbouring channel vector
    "conv1d_any_neighbour_weights": (
        "    const float* wp = ws + (r - r0) * A::CH + v * VEC;\n",
        "    const float* wp = ws + (r - r0) * A::CH + (v + 1) % A::CB * VEC;"
        "\n"),
}
# Yardsticks of the runtime-FL kernel, built as the planted faults are and
# timed beside it in phase wide_paths (``time_conv1d_variants``).
CONV1D_ANY_VARIANTS = {
    # the slabs' copies and the stores alone: no tap is summed (the output
    # is 0)
    "conv1d_any_stream_only": (
        "      walk_taps<T, VEC, false>(smem + n % 2 * slab, ws, 0, FL, run0, "
        "v, acc);\n",
        "      if (FL < 0) walk_taps<T, VEC, false>(smem, ws, 0, FL, run0, v, "
        "acc);\n"),
    # one tile a block: no slab is copied in under another's sums
    "conv1d_any_one_tile": ("constexpr int C1A_NT = 2;",
                            "constexpr int C1A_NT = 1;"),
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
    # in a cluster, each rank adds every peer's sums but the last one's
    "cluster_drops_last_peer": ("if (z < cs) {", "if (z < cs - 1) {"),
    # general path: the index table sends the last input channel to a tap
    # outside the image, so it reads zeros instead of its value
    "table_drops_last_channel": ("(rr << 16) | tt);",
                                 "c == s.C - 1 ? NO_TAP << 16 "
                                 ": (rr << 16) | tt);"),
}
# Yardsticks of the wide decode kernel, built as the planted faults are
# (name -> text of csrc/decode_attention.cu, its replacement) and timed
# beside it in phase wide_paths (``time_decode_variants``).
DECODE_WIDE_VARIANTS = {
    # the ring of bulk copies alone: every tile is copied and waited for,
    # and no score, softmax or V pass runs (the output is not the
    # function's)
    "wide_decode_stream_only": (
        "    const int nrows = min(R, r_end - (r_begin + it * R));\n",
        "    const int nrows = min(R, r_end - (r_begin + it * R));\n"
        "    if (nrows > 0) continue;\n"),
    # every group on the one instance of DW_HEADS heads, in place of the
    # instance of the fewest heads that cover it
    "wide_decode_one_instance": (
        "  if (dh <= 256 || dh > DA_WIDE_MAX_DH) return (int)cudaErrorInvalidValue;"
        "\n",
        "  if (dh <= 256 || dh > DA_WIDE_MAX_DH) return (int)cudaErrorInvalidValue;"
        "\n  return launch_wide_gh<T, DW_HEADS>(q, k, v, pos, out, lse, ws, "
        "tickets, s, dh, stream, blocks_per_sm);\n"),
}
# What each edited build holds: its dict, the file it edits, the sources
# built with it.
PLANTED = ((FLASH_BF16_FAULTS, "flash_attention.cu", ("flash_attention.cu",)),
           (DECODE_WIDE_FAULTS, "decode_attention.cu",
            ("decode_attention.cu",)),
           (CNN_FAULTS, "gemm_pipe.cuh", ("conv2d.cu", "matmul.cu")),
           (DECODE_WIDE_VARIANTS, "decode_attention.cu",
            ("decode_attention.cu",)),
           (CONV1D_ANY_FAULTS, "conv1d.cu", ("conv1d.cu",)),
           (CONV1D_ANY_VARIANTS, "conv1d.cu", ("conv1d.cu",)))
# The bf16 wide flash instances (csrc/flash_attention.cu, launch_wide): one
# per dh ceiling, each of which must hold HMMA instructions in its SASS
WIDE_MMA_INSTANCES = 3


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
        ratio = err_over_tol(diff, tol)
        ok = ratio <= 1.0 and bool(torch.isfinite(got.float()).all())
        self.cases.append({
            "kernel": kernel, **case, "max_abs_err": diff.max().item(),
            "tol": tol if isinstance(tol, float) else tol.min().item(),
            "err_over_tol": ratio, "ok": ok})

    def failures(self) -> list[dict]:
        return [c for c in self.cases if not c["ok"]]


def err_over_tol(diff: torch.Tensor, tol) -> float:
    """The largest err / tol of a check, with err <= tol read as stated
    where a tolerance per element is 0 (bf16 attention's 2^-6 x sum_j p_j
    |v_j| where that sum is 0): no error passes there (0), any error fails
    (inf)."""
    ratio = diff / tol
    if isinstance(tol, torch.Tensor):
        ratio = torch.where(diff == 0, torch.zeros_like(ratio), ratio)
    return ratio.max().item()


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
    kw = {k: v for k, v in kw.items() if k != "return_lse"}
    return 2.0 ** -6 * plain(*a, **kw)


def _lse_err(got, want) -> float:
    """Decode's log-sum-exp against the plain version's, relative to
    max(1, |plain|); inf where one is -inf (no visible row) and the other
    is not."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return math.inf
    if not fin.any():
        return 0.0
    return ((got[fin] - want[fin]).abs()
            / want[fin].abs().clamp(min=1.0)).max().item()


def _epilogue_combos():
    """All 16 subsets of (scale, bias, residual, relu)."""
    return list(itertools.product((False, True), repeat=4))


# ------------------------------------------------------------- shapes ------
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


def launch_grids(fn, kernel: str, tries: int = 4) -> tuple[list, list]:
    """The launches of one call of fn whose kernel's name holds
    ``kernel``, as the profiler's trace records them (name, grid and
    block), and the names of every kernel the last trace holds.  A trace
    without such a launch is taken again, up to ``tries`` times, with
    host activity recorded and without it in turns (the profiler loses
    its events now and then; ``device_kernels``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    found, seen = [], []
    for i in range(tries):
        acts = ([ProfilerActivity.CPU] if i % 2 == 0 else []) + [
            ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        seen = [e.get("name", "")[:80] for e in kernels]
        found = [{"name": e["name"], "grid": e["args"].get("grid"),
                  "block": e["args"].get("block")}
                 for e in kernels if kernel in e.get("name", "")]
        if found:
            break
    return found, seen


def host_profile(fn, reps: int = PROFILE_REPS) -> dict:
    """Where the host's time per call of fn goes: cProfile, top functions.

    Host microseconds per call by own time (``tottime``); cProfile adds its
    own cost to every Python call, so read the ranking, not the sum.  Two
    calls come first: a CNN forward captures its CUDA graph on the second
    (``models.cnn_graph``), so the profiled calls replay it.
    """
    import cProfile
    import pstats
    fn()
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
    """One counted forward, parity against the plain engine, median time.

    The counted call is the first under its key, so it runs eagerly
    (``models.cnn_graph``); the next two capture and replay the net's CUDA
    graph, dense or pruned, and must give the counted call's bits.  The
    captured graph must hold programmatic edges (the convs chained by
    programmatic dependent launch); their count is reported, and beside it
    the count of kernels launched in thread block clusters (split convs
    whose partial sums meet in distributed shared memory), which must not
    be 0 for ResNet-50.  A
    pruned forward prunes on its first call only.  The timed calls and the
    profile replay."""
    from repro_torch.models import cnn_graph
    for fn in counters.values():
        fn.launches = 0
    cnn_graph.reset(apply)
    logits = apply(params, x, **kw)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    again = [apply(params, x, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    same_bits = all(torch.equal(y, logits) for y in again)
    graph = {"captures": apply.graph_captures,
             "replays": apply.graph_replays,
             "eager": dict(apply.graph_eager)}
    want_graph = {"captures": 1, "replays": 2, "eager": {"new_key": 1}}
    edges = apply.graph_programmatic_edges
    clustered = apply.graph_cluster_kernels
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
           "graph": graph, "graph_programmatic_edges": edges,
           "graph_cluster_kernels": clustered,
           "replay_bits_equal_eager": same_bits,
           "median_ms": statistics.median(times), "min_ms": min(times),
           **profile_busy(lambda: apply(params, x, **kw)),
           "prunes": apply.prunes,
           "prune_hits": apply.prune_hits}
    emit(rec)
    if rec["prunes"] != (1 if kw.get("sparse") else 0):
        raise SystemExit(f"{name}: pruned {rec['prunes']} times")
    if launches != expected:
        raise SystemExit(f"{name}: launches {launches} != {expected}")
    if edges == 0:
        raise SystemExit(f"{name}: the captured graph holds no programmatic "
                         "edge: its convs run one after another")
    if clustered == 0 and apply.__name__ == "resnet50_apply":
        raise SystemExit(f"{name}: the captured graph holds no kernel "
                         "launched in clusters: every split conv combines "
                         "through the L2")
    if graph != want_graph or not same_bits:
        raise SystemExit(f"{name}: graph counters {graph} (want "
                         f"{want_graph}), the next calls' bits equal the "
                         f"counted call's: {same_bits}")
    if not (rec["finite"] and err <= tol):
        raise SystemExit(f"{name}: logits off the plain engine by {err} "
                         f"(tol {tol})")
    return rec


# -------------------------------------------------- EfficientNetV2-S ------
def efficientnet_calls(trace, apply, params, x) -> list[dict]:
    """Every kernel call of one EfficientNetV2-S forward, in order, traced
    on the plain engine: the pipelined convs and 1x1s with their epilogue
    tags and stationarity, the depthwise convs, the SE gates and the gate
    passes."""
    with trace.capture() as tr:
        apply(params, x, impl="ref")
    calls = []
    names = ("kernels.conv2d", "kernels.conv1x1", "kernels.dwconv",
             "kernels.se_gate", "kernels.se_scale")
    for sp in sorted((sp for n in names for sp in tr.find(n)),
                     key=lambda sp: sp.start_s):
        a = sp.attrs
        if sp.name == "kernels.conv2d":
            calls.append({"kernel": "conv2d", "x": tuple(a["x_shape"]),
                          "w": tuple(a["w_shape"]), "stride": a["stride"],
                          "padding": a["padding"], "epilogue": a["epilogue"]})
        elif sp.name == "kernels.conv1x1":
            calls.append({"kernel": "mm_weight_stationary"
                          if a["stationarity"] == "weight_stationary"
                          else "mm_act_stationary",
                          "x": tuple(a["x_shape"]), "w": tuple(a["w_shape"]),
                          "stride": a["stride"], "padding": 0,
                          "epilogue": a["epilogue"]})
        elif sp.name == "kernels.dwconv":
            calls.append({"kernel": "dwconv", "x": tuple(a["x_shape"]),
                          "w": tuple(a["w_shape"]), "stride": a["stride"],
                          "epilogue": a["epilogue"]})
        elif sp.name == "kernels.se_gate":
            calls.append({"kernel": "se_gate", "x": tuple(a["sums_shape"]),
                          "w": tuple(a["w1_shape"]), "npix": a["npix"]})
        elif sp.name == "kernels.se_scale":
            calls.append({"kernel": "se_scale", "x": tuple(a["x_shape"])})
    return calls


def efficientnet_operands(call: dict, dtype, gen) -> dict:
    """Random operands of one call in ``dtype``, the epilogue its tag
    names (scale, bias, SiLU, residual) and, for a depthwise conv, its tile
    sums."""
    rn = lambda *s: torch.randn(s, device=gen.device, generator=gen)
    tag = call.get("epilogue", "")
    if call["kernel"] == "se_gate":
        b, tiles, c = call["x"]
        r = call["w"][-1]
        return {"sums": rn(b, tiles, c) * call["npix"] / tiles,
                "w1": (rn(c, r) * c ** -0.5).to(dtype), "b1": 0.3 * rn(r),
                "w2": (rn(r, c) * r ** -0.5).to(dtype), "b2": 0.3 * rn(c)}
    x = rn(*call["x"]).to(dtype)
    if call["kernel"] == "se_scale":
        return {"x": x, "gate": torch.sigmoid(rn(call["x"][0],
                                                 call["x"][-1]))}
    k = call["w"][-1]
    ops = {"x": x, "w": (rn(*call["w"]) * call["w"][0] ** -0.5).to(dtype),
           "scale": 1.0 + 0.2 * rn(k) if "scale" in tag else None,
           "bias": 0.3 * rn(k) if "bias" in tag else None,
           "silu": "silu" in tag}
    if call["kernel"] == "dwconv":
        ops["sums"] = "sums" in tag
        return ops
    if "residual" in tag:
        b, h, w, _ = call["x"]
        s = call["stride"]
        if call["kernel"] == "conv2d":
            fh = call["w"][0]
            pad = call["padding"]
            oh, ow = (h + 2 * pad - fh) // s + 1, (w + 2 * pad - fh) // s + 1
        else:
            oh, ow = -(-h // s), -(-w // s)
        ops["residual"] = rn(b, oh, ow, k).to(dtype)
    return ops


def dw_out_shape(call: dict) -> tuple:
    b, h, w, c = call["x"]
    k, s = call["w"][0], call["stride"]
    pad = (k - 1) // 2
    return (b, (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1, c)


def efficientnet_run(call: dict, ops: dict, plain: bool):
    """One call through its wrapper (``plain``: its plain version): the
    output, and for a depthwise conv the tile sums beside it."""
    from repro_torch.kernels import conv2d as conv_mod
    from repro_torch.kernels import dwconv as dw_mod
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import se as se_mod
    from repro_torch.core.modes import Stationarity
    kind = call["kernel"]
    if kind == "se_gate":
        fn = se_mod.se_gate_plain if plain else se_mod.launch
        return fn(ops["sums"], call["npix"], ops["w1"], ops["b1"],
                  ops["w2"], ops["b2"]), None
    if kind == "se_scale":
        if plain:
            return se_mod.se_scale_plain(ops["x"], ops["gate"]), None
        return se_mod.scale_launch(ops["x"], ops["gate"],
                                   torch.empty_like(ops["x"])), None
    ep = {f: ops[f] for f in ("scale", "bias", "silu")}
    if kind == "dwconv":
        b, oh, ow, c = dw_out_shape(call)
        sums = (torch.empty((b, dw_mod.sum_tiles(oh, ow), c),
                            device=ops["x"].device) if ops["sums"] else None)
        fn = dw_mod.dwconv_plain if plain else dw_mod.launch
        return fn(ops["x"], ops["w"], stride=call["stride"], sums=sums,
                  **ep), sums
    ep["residual"] = ops.get("residual")
    if kind == "conv2d":
        fn = conv_mod.conv2d_plain if plain else conv_mod.conv2d
        return fn(ops["x"], ops["w"], stride=call["stride"],
                  padding=call["padding"], **ep), None
    if plain:
        return mm_mod.matmul_plain(ops["x"], ops["w"], stride=call["stride"],
                                   **ep), None
    st = (Stationarity.WEIGHT_STATIONARY if kind == "mm_weight_stationary"
          else Stationarity.ACTIVATION_STATIONARY)
    return mm_mod.matmul(ops["x"], ops["w"], stride=call["stride"],
                         stationarity=st, **ep), None


def efficientnet_reduction(call: dict) -> int:
    kind = call["kernel"]
    if kind == "conv2d":
        return math.prod(call["w"][:3])
    if kind == "dwconv":
        return call["w"][0] * call["w"][1]
    if kind == "se_gate":
        return call["x"][1] + call["x"][2] + call["w"][-1]
    if kind == "se_scale":
        return 1
    return call["w"][0]


def efficientnet_bound_ms(call: dict, dtype, peaks: dict) -> tuple:
    """(least ms, "operations" or "bytes") of one call: each operand read
    and each result written once."""
    es = torch.tensor([], dtype=dtype).element_size()
    kind, tag = call["kernel"], call.get("epilogue", "")
    if kind == "se_gate":
        b, tiles, c = call["x"]
        r = call["w"][-1]
        flops = b * (tiles * c + 4 * c * r)
        nbytes = 4 * b * tiles * c + es * 2 * c * r + 4 * (r + c + b * c)
    elif kind == "se_scale":
        n = math.prod(call["x"])
        flops, nbytes = n, 2 * es * n + 4 * call["x"][0] * call["x"][-1]
    elif kind == "dwconv":
        b, oh, ow, c = dw_out_shape(call)
        k = call["w"][0]
        flops = 2 * b * oh * ow * c * k * k
        nbytes = es * (math.prod(call["x"]) + k * k * c + b * oh * ow * c)
        if "sums" in tag:
            from repro_torch.kernels import dwconv as dw_mod
            nbytes += 4 * b * dw_mod.sum_tiles(oh, ow) * c
    else:
        b, h, w, c = call["x"]
        k = call["w"][-1]
        s = call["stride"]
        if kind == "conv2d":
            fh, pad = call["w"][0], call["padding"]
            oh, ow = (h + 2 * pad - fh) // s + 1, (w + 2 * pad - fh) // s + 1
            x_el = math.prod(call["x"])
        else:
            oh, ow = -(-h // s), -(-w // s)
            x_el = b * oh * ow * c
        m_k = b * oh * ow * k
        flops = 2 * m_k * efficientnet_reduction(call)
        nbytes = es * (x_el + math.prod(call["w"]) + m_k
                       + m_k * ("residual" in tag))
        nbytes += 4 * k * (("scale" in tag) + ("bias" in tag))
    peak = peaks["bf16" if dtype == torch.bfloat16 else "fp32"]
    t_ops, t_bytes = flops / peak, nbytes / peaks["bw"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_efficientnet(chk: Checker, calls: list[dict], peaks: dict, flush,
                       gen) -> dict:
    """Each distinct call of the 384 x 384 batch-1 forward through its
    wrapper against its plain version, fp32 and bf16, the stated
    tolerance (phase checks'); the depthwise conv's tile sums at the fp32
    tolerance of a sum of k*k x 16 terms; the gate pass to the bit.  A
    call must also repeat to the bit.  Then the fp32 device time of every
    call of the forward (cold L2) beside its plain version's and its
    bound, summed by kernel."""
    from repro_torch.kernels import dwconv as dw_mod
    unique = {}
    for c in calls:
        unique.setdefault(json.dumps(c, sort_keys=True), c)
    for c in unique.values():
        for dtype in (torch.float32, torch.bfloat16):
            ops = efficientnet_operands(c, dtype, gen)
            got, sums = efficientnet_run(c, ops, plain=False)
            want, want_sums = efficientnet_run(c, ops, plain=True)
            again, _ = efficientnet_run(c, ops, plain=False)
            case = {**{f: c[f] for f in ("x", "w", "stride", "epilogue")
                       if f in c}, "dtype": str(dtype)[6:]}
            chk.add(c["kernel"], case, got, want, efficientnet_reduction(c))
            rec = chk.cases[-1]
            same = torch.equal(got, again)
            if c["kernel"] == "se_scale":
                same = same and torch.equal(got, want)
            rec.update(repeat_identical=same, ok=rec["ok"] and same)
            if sums is not None:
                chk.add("dwconv sums", case, sums, want_sums,
                        efficientnet_reduction(c) * dw_mod.TILE_PIX)
    torch.cuda.synchronize()
    by_kernel = {}
    for c in calls:
        ops = efficientnet_operands(c, torch.float32, gen)
        bound, by = efficientnet_bound_ms(c, torch.float32, peaks)
        row = by_kernel.setdefault(c["kernel"], {
            "calls": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": {"operations": 0.0, "bytes": 0.0}})
        row["calls"] += 1
        row["ms"] += cold_time_ms(lambda: efficientnet_run(c, ops, False),
                                  flush)
        row["plain_ms"] += cold_time_ms(
            lambda: efficientnet_run(c, ops, True), flush)
        row["bound_ms"] += bound
        row["bound_by"][by] += bound
    for kname, row in by_kernel.items():
        cs = [c for c in chk.cases if c["kernel"] == kname]
        row.update(cases=len(cs), failed=sum(not c["ok"] for c in cs),
                   max_abs_err=max(c["max_abs_err"] for c in cs
                                   if c["dtype"] == "float32"),
                   max_err_over_tol=max(c["err_over_tol"] for c in cs),
                   bound_by=max(row["bound_by"], key=row["bound_by"].get))
    return by_kernel


class StagedGates:
    """``se_gate.staged_launches`` read and reset as ``run_model`` reads and
    resets a wrapper's ``launches``."""

    @property
    def launches(self) -> int:
        from repro_torch.kernels import se as se_mod
        return se_mod.se_gate.staged_launches

    @launches.setter
    def launches(self, n: int) -> None:
        from repro_torch.kernels import se as se_mod
        se_mod.se_gate.staged_launches = n


def run_efficientnet(trace, counters: dict, no_lm: dict, peaks: dict, flush,
                     gen) -> tuple[dict, dict]:
    """EfficientNetV2-S at 384 x 384, batch 1: every distinct kernel call
    of its forward checked and timed (``check_efficientnet``), then the
    forward through ``run_model``, whose counted call must launch each
    kernel as often as the traced plain forward dispatched it: the
    depthwise convs, SE gates and gate passes among them, every gate in its
    staged instance."""
    from repro_torch.kernels import dwconv as dw_mod
    from repro_torch.kernels import se as se_mod
    from repro_torch.models import efficientnet
    apply = efficientnet.efficientnetv2_s_apply
    cpu = torch.Generator().manual_seed(SEED + 2)
    params = efficientnet.efficientnetv2_s_init(
        torch.Generator().manual_seed(SEED + 2))
    randomize_bn(params, cpu)
    for key, blk in params.items():
        if "se" in blk:
            for b in ("b1", "b2"):
                n = blk["se"][b].shape[0]
                blk["se"][b] = (0.3 * torch.randn(n, generator=cpu)).cuda()
    x = torch.randn((1, 384, 384, 3), generator=cpu).cuda()
    calls = efficientnet_calls(trace, apply, params, x)
    chk = Checker()
    t0 = time.perf_counter()
    by_kernel = check_efficientnet(chk, calls, peaks, flush, gen)
    emit({"phase": "efficientnet_checks", "calls": len(calls),
          "cases": len(chk.cases), "seconds": time.perf_counter() - t0,
          **by_kernel})
    if chk.failures():
        dump({"efficientnet_checks": chk.cases})
        raise SystemExit(f"efficientnetv2_s: {len(chk.failures())} kernel "
                         f"checks failed, first: {chk.failures()[:1]}")
    expected = {**{k: 0 for k in counters}, **no_lm,
                "dwconv": 0, "se_gate": 0, "se_scale": 0}
    for c in calls:
        expected[c["kernel"]] += 1
    # every gate of the net holds its weights' slices in shared memory
    expected["se_gate_staged"] = expected["se_gate"]
    counted = {**counters, "dwconv": dw_mod.dwconv,
               "se_gate": se_mod.se_gate, "se_scale": se_mod.se_scale,
               "se_gate_staged": StagedGates()}
    rec = run_model("efficientnetv2_s", apply, params, x, counted, expected)
    return rec, by_kernel


# --------------------------------------------------------- LM kernels ------
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
                perr = err_over_tol(
                    (plain_split.float() - want.float()).abs(), tol)
                rec.update(bits_equal_unsplit_launch=torch.equal(got, whole),
                           plain_split_err_over_tol=perr,
                           ok=rec["ok"] and perr <= 1.0)
                bad = split_call(case, args, kw, n, wrapper, da_mod, fault=1)
                ratio = err_over_tol((bad.float() - want.float()).abs(), tol)
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
    per planted fault and yardstick of ``PLANTED``, each building its
    source against a copy of csrc/ in a temporary directory with the one
    edit made.  Returns the main build's nvcc seconds and (name, source
    stem) -> the edited library's path (in a directory that lives as long
    as the process)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_faults_"))
    atexit.register(shutil.rmtree, tmp, True)
    procs, libs = {}, {}
    try:
        for faults, edited, targets in PLANTED:
            text = (_build.CSRC / edited).read_text()
            for name, (old, new) in faults.items():
                if text.count(old) != 1:
                    raise SystemExit(f"edited build {name}: its text is not "
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
                raise SystemExit(f"edited build {tag}: nvcc failed: "
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


def check_decode_faults(_build, da_mod, libs: dict, gen) -> dict:
    """Each DECODE_WIDE_FAULTS library through the decode wrapper on the
    bf16 wide-head decode cases of lm_kernel_cases, at their tolerance:
    how many cases fail and the worst err / tol.  Raises unless every
    fault fails one."""
    cases = [c for c in lm_kernel_cases()
             if c["kernel"] == "decode_attention" and c["dh"] > 256]
    plain = da_mod.decode_attention_plain
    out = {}
    for name in DECODE_WIDE_FAULTS:
        lib = load_fault(libs[name, "decode_attention"], da_mod._SIGNATURES)
        chk = Checker()
        with mock.patch.object(_build, "load", lambda *_: lib):
            for case in cases:
                args, kw = lm_operands(case, torch.bfloat16, gen)
                got, want = da_mod.decode_attention(*args, **kw), \
                    plain(*args, **kw)
                if isinstance(got, tuple):
                    got, want = got[0], want[0]
                chk.add("decode_attention", case, got, want, case["dh"],
                        _attn_tol(want, plain, args, kw))
        torch.cuda.synchronize()
        out[name] = {"cases_failed": len(chk.failures()), "of": len(cases),
                     "max_err_over_tol": max(c["err_over_tol"]
                                             for c in chk.cases)}
    missed = [n for n, r in out.items() if not r["cases_failed"]]
    if missed:
        raise SystemExit(f"the wide decode checks miss planted faults "
                         f"{missed}: {out}")
    return out


def check_conv1d_faults(_build, c1_mod, libs: dict, gen) -> dict:
    """Each CONV1D_ANY_FAULTS library through the conv1d wrapper on the
    any-FL cases of lm_kernel_cases whose FL no template instance takes
    (fp32 and bf16), at the lm_checks tolerance: how many cases fail and
    the worst err / tol.  Raises unless every fault fails one."""
    cases = [c for c in any_fl_cases() if c["fl"] not in c1_mod.FLS]
    plain = c1_mod.conv1d_causal_plain
    out = {}
    for name in CONV1D_ANY_FAULTS:
        lib = load_fault(libs[name, "conv1d"], c1_mod._SIGNATURES)
        chk = Checker()
        with mock.patch.object(_build, "load", lambda *_: lib):
            for case in cases:
                for dtype in (torch.float32, torch.bfloat16):
                    args, _ = lm_operands(case, dtype, gen)
                    chk.add("conv1d_causal", {**case, "dtype": str(dtype)[6:]},
                            c1_mod.conv1d_causal(*args), plain(*args),
                            case["fl"])
        torch.cuda.synchronize()
        out[name] = {"cases_failed": len(chk.failures()), "of": len(chk.cases),
                     "max_err_over_tol": max(c["err_over_tol"]
                                             for c in chk.cases)}
    missed = [n for n, r in out.items() if not r["cases_failed"]]
    if missed:
        raise SystemExit(f"the any-FL conv1d checks miss planted faults "
                         f"{missed}: {out}")
    return out


def wide_mma_hmma(tc: dict | str) -> dict:
    """HMMA and HGMMA counts of the bf16 wide flash instances in the flash
    library's SASS (``tensor_core_counts``); raises unless each of the
    WIDE_MMA_INSTANCES has tensor-core instructions."""
    found = ({} if isinstance(tc, str) else
             {n: c for n, c in tc["by_kernel"].items()
              if "flash_wide_mma_kernel" in n})
    if len(found) != WIDE_MMA_INSTANCES:
        raise SystemExit(f"build: the bf16 wide flash instances are not on "
                         f"the tensor cores: {found or tc}")
    return found


def check_cnn_faults(kern, _build, libs: dict, calls: list, gen) -> dict:
    """Each CNN_FAULTS library pair through the conv2d and weight-stationary
    wrappers on their fp32 main-path shapes (the full epilogue), at the
    checks' tolerance: how many cases of each kernel fail and the worst
    err / tol.  Raises unless every fault fails a case, and unless a
    dropped split fails a weight-stationary case: the last split through
    the L2, or the last peer of a cluster, whichever combine the
    weight-stationary launches take (csrc/gemm_pipe.cuh)."""
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
    if missed or not any(
            out[f]["mm_weight_stationary"]["cases_failed"]
            for f in ("combine_drops_last_split", "cluster_drops_last_peer")):
        raise SystemExit(f"the fp32 conv2d and weight-stationary checks miss "
                         f"planted faults {missed}: {out}")
    return out


def check_lm_kernels(chk: Checker, lm_kernels: dict, gen) -> dict:
    """Every LM case, fp32 and bf16, against the plain version, and run
    twice for the same bits; each call must launch its kernel once (its
    counter), and a decode log-sum-exp must be within 1e-4 x max(1,
    |plain|) of the plain one's."""
    for case in lm_kernel_cases():
        wrapper, plain = lm_kernels[case["kernel"]]
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = lm_operands(case, dtype, gen)
            before = wrapper.launches
            got, want = wrapper(*args, **kw), plain(*args, **kw)
            launched = wrapper.launches - before
            lse_err = None
            if isinstance(got, tuple):
                lse_err = _lse_err(got[1], want[1])
                got, want = got[0], want[0]
            tol = (None if case["kernel"] == "conv1d_causal"
                   else _attn_tol(want, plain, args, kw))
            chk.add(case["kernel"], {**case, "dtype": str(dtype)[6:]}, got,
                    want, lm_reduction(case), tol)
            again = wrapper(*args, **kw)
            same = torch.equal(got, again[0] if lse_err is not None
                               else again)
            rec = chk.cases[-1]
            rec.update(repeat_identical=same, launches=launched,
                       ok=rec["ok"] and same and launched == 1)
            if lse_err is not None:
                rec.update(lse_err=lse_err, ok=rec["ok"] and lse_err <= 1e-4)
            del args, got, want, again
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
    # the paths no config has, apart
    summary["wide_head_dims"] = _subset(chk, lambda c: c.get("dh", 0) > 256)
    summary["any_fl"] = _subset(chk, lambda c: c["kernel"] == "conv1d_causal"
                                and c["fl"] not in (2, 3, 4))
    return summary


def _subset(chk: Checker, pick) -> dict:
    cs = [c for c in chk.cases if pick(c)]
    return {"cases": len(cs), "failed": sum(not c["ok"] for c in cs),
            "launches": sum(c["launches"] for c in cs),
            "max_err_over_tol": max(c["err_over_tol"] for c in cs),
            "max_lse_err": max((c["lse_err"] for c in cs if "lse_err" in c),
                               default=None)}


def time_lm_kernels(lm_kernels: dict, peaks: dict, flush, gen) -> dict:
    """Each LM kernel at its zamba2 main-path shape, bf16, cold L2.  The
    decode call reads the whole cache (pos = S - 1 for every sequence)."""
    rows = {}
    for case in lm_kernel_cases()[:3]:
        kname = case["kernel"]
        pos = ((case["s"] - 1,) * case["b"]
               if kname == "decode_attention" else None)
        rows[kname] = time_lm_case(*lm_kernels[kname], case, torch.bfloat16,
                                   peaks, flush, gen, pos)
        if kname == "decode_attention":
            # a yardstick of the memory system, not a bound: a device copy
            # of the K cache moves as many bytes as decode reads (half read,
            # half written)
            args, _ = lm_operands(case, torch.bfloat16, gen, pos)
            rows[kname]["cache_copy_ms"] = cold_time_ms(args[1].clone, flush)
    return rows


def time_decode_paths(lm_kernels: dict, peaks: dict, flush, gen) -> dict:
    """Decode at the new paths' shapes (``decode_path_cases``), bf16, cold
    L2, at each case's positions, beside its bound (the rows its mask lets
    in), its plain version and SDPA with the same position mask (SDPA has
    no soft-cap: a yardstick of the shape)."""
    return {name: time_lm_case(*lm_kernels["decode_attention"], case,
                               torch.bfloat16, peaks, flush, gen)
            for name, case in zip(DECODE_PATH_NAMES, decode_path_cases(),
                                  strict=True)}


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
        pos = ((case["s"] - 1,) * case["b"]
               if case["kernel"] == "decode_attention" else None)
        name = (f"flash window {case['window']}"
                if case["kernel"] == "flash_attention" else "decode")
        times[name] = time_lm_case(*lm_kernels[case["kernel"]], case,
                                   torch.bfloat16, peaks, flush, gen, pos,
                                   plain_reps=3)
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


def cut_model(lm, arch: str, *, smoke: bool = False, **changes):
    """(config, parameters) of ``arch`` (its smoke config with ``smoke``)
    with ``changes`` made (its depth cut by ``n_layers``): random fp32
    weights from SEED on the card, with their bf16 compute copies."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import with_compute_copies
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), **changes)
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
    cfg, params = cut_model(lm, "gemma2-9b", n_layers=G_LAYERS)
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
    cfg, params = cut_model(lm, "mixtral-8x7b", n_layers=M_LAYERS)
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
def run_smollm_dh20(serve, lm, attn_mod, fa_mod, da_mod, counters: dict,
                    lm_kernels: dict, peaks: dict, flush) -> dict:
    """Phase smollm_dh20: smollm-360m's smoke config (2 layers, d_model 60,
    3 heads over 1 of dh 20, which the attention wrappers zero-pad to 64 at
    the unpadded scale) served on the card through ``launch.serve``
    (``serve_path``): SD_BATCH x SD_PROMPT-token prompts, SD_GEN tokens; a
    flash launch per layer per prefill, a decode launch per layer per step;
    the three planted faults of ``planted_faults``.  Beside it decode's
    log-sum-exp at dh 20 (``return_lse``, the sharded combine's input)
    against the plain version's, fp32, within 1e-4.  After it the two dh
    20 calls in bf16, cold L2 (``time_lm_case``), and what their padding
    costs (``time_padding``: the wrapper beside the same launch on operands
    padded beforehand, which must give the same bits, and the pads
    alone)."""
    cfg, params = serve.load_model("smollm-360m", smoke=True, device=DEVICE,
                                   seed=SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    case = dh20_cases()[1]
    args, kw = lm_operands(case, torch.float32, gen)
    _, lse = da_mod.decode_attention(*args, **kw, return_lse=True)
    _, plain_lse = da_mod.decode_attention_plain(*args, **kw,
                                                 return_lse=True)
    lse_err = (lse - plain_lse).abs().max().item()
    if not lse_err <= 1e-4:
        raise SystemExit(f"smollm_dh20: decode's log-sum-exp at dh 20 off "
                         f"the plain version's by {lse_err}")
    prompts = serve.make_prompts(cfg, SD_BATCH, SD_PROMPT, device=DEVICE,
                                 seed=SEED)
    rec = serve_path("smollm_dh20", serve, lm, cfg, params, prompts, SD_GEN,
                     counters, {"flash_attention": cfg.n_layers},
                     {"decode_attention": cfg.n_layers},
                     planted_faults(attn_mod, fa_mod, da_mod, cfg.n_layers))
    times = {}
    for case in dh20_cases():
        kname = case["kernel"]
        times[kname] = {
            **time_lm_case(*lm_kernels[kname], case, torch.bfloat16, peaks,
                           flush, gen),
            "padding": time_padding(case, torch.bfloat16, flush, gen)}
    emit({"phase": "smollm_dh20", "head_dim": cfg.d_model // cfg.n_heads,
          "decode_lse_max_abs_err": lse_err,
          "times_bf16": {k: {f: r[f] for f in (
              "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
              "padding")} for k, r in times.items()}})
    unequal = [k for k, r in times.items()
               if not r["padding"]["prepadded_bits_equal"]]
    if unequal:
        raise SystemExit(f"smollm_dh20: {unequal} on operands padded "
                         "beforehand differ from the padding wrapper")
    return {**rec, "decode_lse_max_abs_err": lse_err, "times_bf16": times}


def run_wide_paths(serve, lm, attn_mod, fa_mod, da_mod, counters: dict,
                   lm_kernels: dict, peaks: dict, flush, libs: dict,
                   grid: dict) -> dict:
    """Phase wide_paths: the paths no config has, served through
    ``launch.serve`` as phase zamba2 (``serve_path``).  gemma2-9b's smoke
    config with 4 heads over 2 of dh WIDE_DH (the wide attention kernels,
    unpadded; two local layers on rings of 16 slots, two global; soft-cap
    50), WP_BATCH x WP_PROMPT-token prompts, WP_GEN tokens: a flash launch
    per layer per prefill, a decode launch per layer per step.
    zamba2-2.7b's smoke config with d_conv WP_FL (conv1d's runtime-FL
    kernel): a conv1d launch per layer and a flash launch per group per
    prefill, a decode launch per group per step.  Each with the three
    faults of ``planted_faults``.  Then each of ``wide_time_cases`` in
    bf16, cold L2, beside its bound, plain version and library call; the
    wide decode launch's grid at its timed shape (``wide_decode_grid``,
    read in phase build); the wide decode kernel beside its yardsticks (``time_decode_variants``);
    and the wide instances' registers and spills, none of which may
    spill."""
    from repro_torch.kernels import _build
    g_cfg, g_params = cut_model(lm, "gemma2-9b", smoke=True,
                                d_head=WIDE_DH)
    prompts = serve.make_prompts(g_cfg, WP_BATCH, WP_PROMPT, device=DEVICE,
                                 seed=SEED)
    wide = serve_path(f"gemma2_smoke_dh{WIDE_DH}", serve, lm, g_cfg,
                      g_params, prompts, WP_GEN, counters,
                      {"flash_attention": g_cfg.n_layers},
                      {"decode_attention": g_cfg.n_layers},
                      planted_faults(attn_mod, fa_mod, da_mod,
                                     g_cfg.n_layers))
    del g_params
    z_cfg, z_params = cut_model(lm, "zamba2-2.7b", smoke=True,
                                d_conv=WP_FL)
    prompts = serve.make_prompts(z_cfg, WP_BATCH, WP_PROMPT, device=DEVICE,
                                 seed=SEED)
    any_fl = serve_path(f"zamba2_smoke_fl{WP_FL}", serve, lm, z_cfg,
                        z_params, prompts, WP_GEN, counters,
                        {"conv1d_causal": z_cfg.n_layers,
                         "flash_attention": z_cfg.n_groups},
                        {"decode_attention": z_cfg.n_groups},
                        planted_faults(attn_mod, fa_mod, da_mod,
                                       z_cfg.n_groups))
    del z_params
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    times, times_fp32 = {}, {}
    for case in wide_time_cases():
        kname = case["kernel"]
        times[kname] = time_lm_case(*lm_kernels[kname], case, torch.bfloat16,
                                    peaks, flush, gen, plain_reps=3)
        if kname == "decode_attention":
            # a yardstick of the memory system, not a bound: a device copy
            # of the K cache moves as many bytes as decode reads
            args, _ = lm_operands(case, torch.bfloat16, gen)
            times[kname]["cache_copy_ms"] = cold_time_ms(args[1].clone, flush)
            del args
        # the fp32 instances (the CUDA cores; TF32 stays off) beside
        times_fp32[kname] = time_lm_case(
            *lm_kernels[kname], case, torch.float32, peaks, flush, gen,
            reps=5, plain_reps=1)
    ptx = {n: {**ptxas_instances(_build.build_log(n), "wide"),
               **ptxas_instances(_build.build_log(n), "any")}
           for n in ("flash_attention", "decode_attention", "conv1d")}
    spilled = {k: r for n in ("flash_attention", "decode_attention", "conv1d")
               for k, r in ptx[n].items() if r.get("spill_store_bytes")
               or r.get("spill_load_bytes")}
    variants = time_decode_variants(_build, da_mod, libs,
                                    wide_time_cases()[1], flush, gen)
    c1_variants = time_conv1d_variants(_build, libs, wide_time_cases()[2],
                                       flush, gen)
    emit({"phase": "wide_paths", "decode_grid": grid,
          "decode_variants": variants, "conv1d_variants": c1_variants,
          "served": {r["phase"]: {f: r[f] for f in (
              "launches_per_prefill", "launches_per_decode_step")}
                     for r in (wide, any_fl)},
          "ptxas": ptx,
          "times_bf16": {k: {f: r[f] for f in TIME_FIELDS if f in r}
                         for k, r in times.items()},
          "times_fp32": {k: {f: r[f] for f in TIME_FIELDS if f in r}
                         for k, r in times_fp32.items()}})
    if spilled:
        raise SystemExit(f"wide_paths: wide and runtime-FL instances that "
                         f"spill {spilled}")
    return {"wide": wide, "any_fl": any_fl, "ptxas": ptx,
            "times_bf16": times, "times_fp32": times_fp32,
            "decode_grid": grid, "decode_variants": variants,
            "conv1d_variants": c1_variants}


# the fields of a time_lm_case row that the phases print
TIME_FIELDS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
               "max_abs_err", "cache_copy_ms", "copy_ms",
               "contiguous_copy_ms")


def time_conv1d_variants(_build, libs: dict, case: dict, flush,
                         gen) -> dict:
    """conv1d's runtime-FL kernel beside its yardsticks
    (``CONV1D_ANY_VARIANTS``) through the wrapper at ``case``, bf16 and
    fp32, cold L2, in turns (kernel, variant, variant, kernel); the
    one-tile variant must give the kernel's bits."""
    from repro_torch.kernels import conv1d as c1_mod
    base = _build.load("conv1d", c1_mod._SIGNATURES)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args, _ = lm_operands(case, dtype, gen)
        rec = out[str(dtype)[6:]] = {}
        for name in CONV1D_ANY_VARIANTS:
            lib = load_fault(libs[name, "conv1d"], c1_mod._SIGNATURES)
            ms = [conv1d_with(x, args, flush) for x in (base, lib, lib, base)]
            rec[name] = {"kernel_ms": [ms[0], ms[3]],
                         "variant_ms": [ms[1], ms[2]]}
            if name == "conv1d_any_one_tile":
                rec[name]["same_bits"] = torch.equal(
                    conv1d_with(lib, args), conv1d_with(base, args))
        del args
    unequal = [d for d, r in out.items()
               if not r["conv1d_any_one_tile"]["same_bits"]]
    if unequal:
        raise SystemExit(f"wide_paths: conv1d's one-tile variant differs "
                         f"from the kernel in {unequal}: {out}")
    return out


def wide_decode_grid() -> dict:
    """``print_decode_grid`` in a process of its own, which prints the wide
    decode launch's grid as its last line.  Not in this process: here,
    profiler sessions after one whose trace was exported recorded no
    device activity, and a trace taken late in the run held no kernel."""
    code = (f"import sys; sys.path[:0] = [{str(HERE / 'src')!r}, "
            f"{str(HERE)!r}]; import chip_smoke; "
            f"chip_smoke.print_decode_grid()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise SystemExit(f"build: the wide decode grid's process failed: "
                         f"{out.stdout[-1000:]} {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def print_decode_grid() -> None:
    """Prints the wide decode launch at its timed shape
    (``wide_time_cases``), bf16, as the profiler's trace of one wrapper
    call records it (``launch_grids``), beside the splits the wrapper
    planned: its blocks must be B x KH x splits (one per kv head, the
    group's heads scored together), not B x H x splits (one per query
    head)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da_mod
    case = wide_time_cases()[1]
    b, s, h, kh, dh = (case[k] for k in ("b", "s", "h", "kh", "dh"))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    args, kw = lm_operands(case, torch.bfloat16, gen)
    launches, seen = launch_grids(
        lambda: da_mod.decode_attention(*args, **kw), "decode_wide_kernel")
    lib = _build.load("decode_attention", da_mod._SIGNATURES)
    slots = da_mod._resident_blocks(lib, torch.device(DEVICE), 1, h, kh, dh)
    plan = da_mod.launch_plan(b, s, h, kh, dh, slots)
    emit({"launches": launches, "slots": slots, "splits": plan.splits,
          "split_tiles": plan.split_tiles,
          "blocks": (math.prod(launches[0]["grid"])
                     if len(launches) == 1 and launches[0]["grid"] else None),
          "b_kh_splits": b * kh * plan.splits,
          "b_h_splits": b * h * plan.splits,
          **({} if launches else {"traced_kernels": seen})})


def time_decode_variants(_build, da_mod, libs: dict, case: dict, flush,
                         gen) -> dict:
    """The wide decode kernel beside its yardsticks (``DECODE_WIDE_VARIANTS``)
    through the wrapper, bf16, cold L2, in turns (kernel, variant, variant,
    kernel): the stream alone at the case's shape, and the one instance of
    DW_HEADS heads at the case's group and at a group of one (H = KH, the
    same cache), with the largest difference of its output from the
    kernel's."""
    base = _build.load("decode_attention", da_mod._SIGNATURES)

    def run(lib, fn, timed: bool):
        with mock.patch.object(_build, "load", lambda *_: lib), \
                mock.patch.dict(da_mod._slots, clear=True):
            return cold_time_ms(fn, flush) if timed else fn()

    out = {}
    for name, groups in (("wide_decode_stream_only", (case["h"] // case["kh"],)),
                         ("wide_decode_one_instance",
                          (case["h"] // case["kh"], 1))):
        lib = load_fault(libs[name, "decode_attention"], da_mod._SIGNATURES)
        for g in groups:
            c = {**case, "h": case["kh"] * g}
            args, kw = lm_operands(c, torch.bfloat16, gen)
            fn = lambda: da_mod.decode_attention(*args, **kw)
            ms = [run(l, fn, True) for l in (base, lib, lib, base)]
            row = {"kernel_ms": [ms[0], ms[3]], "variant_ms": [ms[1], ms[2]]}
            if name == "wide_decode_one_instance":
                row["max_abs_diff"] = (run(lib, fn, False).float()
                                       - run(base, fn, False).float()
                                       ).abs().max().item()
            out[f"{name} G {g}"] = row
    return out


def run_bench(baseline: Path) -> dict:
    """Phase bench: the bench record at full size on the card
    (``bench.telemetry_report.collect_bench`` over ``bench.run``'s
    networks: ResNet-50 and VGG-16 unfused and fused, ResNet-50's sparse
    twin, the smoke sets), with the committed tuned tables.  Hard gates:
    every fused block touches strictly fewer bytes than unfused and every
    pruned layer strictly fewer than its dense twin.  Then
    ``bench.check_regression`` against the committed baseline: its
    verdict and worst ratio are printed, and a timing miss alone does not
    fail this run (another card may run at other clocks; the CLI gate is
    where timing is hard)."""
    from repro_torch.bench import check_regression as cr
    from repro_torch.bench.run import bench_nets
    from repro_torch.bench.telemetry_report import collect_bench
    t0 = time.perf_counter()
    rec = collect_bench(bench_nets(False, True), tuned=True)
    seconds = time.perf_counter() - t0
    blocks = [b for fd in rec["fused_delta"].values() for b in fd["blocks"]]
    pruned = [l for sd in rec["sparse_delta"].values() for l in sd["layers"]
              if l["pruned"]]
    bytes_bad = cr.check_bytes(rec)
    verdict = {"baseline": baseline.name, "found": baseline.exists()}
    if baseline.exists():
        base = cr.load(str(baseline))
        problems = (cr.compare(base, rec) + cr.check_tuning(rec)
                    + cr.check_sparse(rec) + cr.check_stale_tables())
        ratio, where = cr.worst_ratio(base, rec)
        verdict.update(passed=not problems, problems=problems[:10],
                       n_problems=len(problems), worst_ratio=ratio,
                       worst_at=where, baseline_device=base.get("device"))
    out = {"phase": "bench", "seconds": seconds, "device": rec["device"],
           "timer": rec["timer"],
           "totals_ms": {n: r["total_measured_ms"]
                         for n, r in rec["networks"].items()},
           "host_totals_ms": {n: r["total_host_ms"]
                              for n, r in rec["networks"].items()},
           "fused_blocks": len(blocks), "pruned_layers": len(pruned),
           "bytes_invariant_problems": bytes_bad,
           "tuning": {n: {k: d[k] for k in ("keys_timed", "keys_missing",
                                             "total_default_ms",
                                             "total_tuned_ms")}
                      for n, d in rec["tuning"].items()},
           "regression": verdict}
    emit(out)
    if not blocks or not pruned or bytes_bad:
        raise SystemExit(f"bench: byte invariants fail over {len(blocks)} "
                         f"fused blocks and {len(pruned)} pruned layers: "
                         f"{bytes_bad[:5]}")
    return {**out, "record": rec}


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
    # the CLI with repro's batch and budget options: the smoke net at batch
    # 2 into a table of its own, whose keys must be the batch-2 keys
    b2_path = os.path.join(tmp, "smoke_batch2.json")
    tune.main(["--net", "smoke", "--batch", "2", "--reps", "2",
               "--candidates", "3", "--out", b2_path])
    with open(b2_path) as f:
        b2_keys = sorted(json.load(f)["entries"])
    cli_batch2 = {"keys": len(b2_keys), "match": b2_keys == sorted(
        {tune.layer_key(l, 2) for l in tune.net_layers("smoke")}),
                  "first_key": b2_keys[0] if b2_keys else None}
    changed = {k: [records[k][0]["short"], e.config.short, e.default_ms,
                   e.tuned_ms]
               for k, e in entries.items() if e.config != records[k][0][
                   "config"]}
    flush = flush_buffer()
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
                child = sp.children[-1].attrs   # the kernel, after the plan
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
    if not cli_batch2["match"]:
        problems.append("cli --batch 2")
    rec = {"phase": "tune", "keys": len(entries), "tune_seconds": tune_s,
           "cli_batch2": cli_batch2,
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
           "measured": "host time per dispatch, call to return (no "
                       "synchronise); util% against the fp32 peak"}
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
        cfg, params = cut_model(lm, "gemma2-9b", n_layers=G_LAYERS)
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
    cfg, params = cut_model(lm, "mixtral-8x7b", n_layers=M_LAYERS)
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
    peaks = peaks_for(f"{name} {smi}")
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
    tc_sass = {src.stem: tensor_core_counts(_build.build_dir()
                                            / f"lib{src.stem}.so")
               for src in _build.sources()}
    wide_hmma = wide_mma_hmma(tc_sass["flash_attention"])
    decode_grid = wide_decode_grid()
    emit({"phase": "build", "nvcc_seconds": nvcc_s,
          "seconds": time.perf_counter() - t0,
          "ptxas": {n: ptxas_summary(lines) for n, lines in ptxas.items()},
          "tensor_core_sass": tc_sass, "wide_flash_bf16_hmma": wide_hmma,
          "wide_decode_grid": decode_grid})
    if (decode_grid["blocks"] != decode_grid["b_kh_splits"]
            or decode_grid["blocks"] == decode_grid["b_h_splits"]):
        raise SystemExit(f"build: the wide decode launch's grid is not one "
                         f"block per kv head: {decode_grid}")

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
    t0 = time.perf_counter()
    emit({"phase": "decode_wide_faults",
          **check_decode_faults(_build, da_mod, fault_libs, dgen),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "conv1d_any_faults",
          **check_conv1d_faults(_build, c1_mod, fault_libs, dgen),
          "seconds": time.perf_counter() - t0})
    train_k = check_train_kernels(fa_mod, c1_mod, dgen)

    # 5. times at the fp32 main-path shapes, with each call's own epilogue
    flush = flush_buffer()
    per_path = {}
    for p, cs in calls.items():
        rows = []
        for c in cs:
            rows.append(time_cnn_call(kern, c, torch.float32, flush, dgen))
            if c["kernel"] == "mm_weight_stationary":
                x_, w_, full = make_operands(kern, c, torch.float32, dgen)
                ep = model_epilogue(full, c["epilogue"])
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
          **{k: {f: r[f] for f in TIME_FIELDS if f in r}
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
    models["efficientnetv2_s"], eff_kernels = run_efficientnet(
        trace, counters, no_lm, peaks, flush, dgen)
    emit({"phase": "host", **host_profile(lambda: cnn.resnet50_apply(r50, x))})
    bench = run_bench(HERE / BASELINE)
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
    smollm = run_smollm_dh20(serve, lm, attn_mod, fa_mod, da_mod, counters,
                             lm_kernels, peaks, flush)
    t0 = time.perf_counter()
    wide = run_wide_paths(serve, lm, attn_mod, fa_mod, da_mod, counters,
                          lm_kernels, peaks, flush, fault_libs, decode_grid)
    emit({"phase": "wide_paths", "seconds": time.perf_counter() - t0})
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
          "smollm_dh20": smollm, "wide_paths": wide, "bench": bench,
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
                 ("rwkv6", rwkv6), ("smollm_dh20", smollm),
                 (f"gemma2_smoke_dh{WIDE_DH}", wide["wide"]),
                 (f"zamba2_smoke_fl{WP_FL}", wide["any_fl"])):
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
    # the paths no config has: the wide attention kernels (dh above 256)
    # and conv1d's runtime-FL kernel, launched by phase wide_paths' served
    # runs and timed at wide_time_cases
    for kname, path, what in (
            ("flash_attention", wide["wide"], f"wide head dim (dh {WIDE_DH})"),
            ("decode_attention", wide["wide"],
             f"wide head dim (dh {WIDE_DH})"),
            ("conv1d_causal", wide["any_fl"], f"runtime FL (FL {WP_FL})")):
        src, replaces = lm_sources[kname]
        r = wide["times_bf16"][kname]
        stem = Path(src).stem
        tag = {"flash_attention": "flash_wide", "decode_attention":
               "decode_wide", "conv1d_causal": "any"}[kname]
        line.append({
            "name": f"{kname} {what}", "route": "cuda", "source": src,
            "replaces": replaces, "launches": path["launches"][kname],
            "launched_by": path["phase"],
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "shapes": "one call, bf16: " + json.dumps(
                {k: v for k, v in r["case"].items() if k != "kernel"}),
            "ptxas": {n: v for n, v in wide["ptxas"][stem].items()
                      if tag in n},
            **({"hmma": wide_hmma} if kname == "flash_attention" else {}),
            "fp32": {f: wide["times_fp32"][kname][f] for f in (
                "ms", "plain_ms", "bound_ms", "max_abs_err", "copy_ms",
                "contiguous_copy_ms") if f in wide["times_fp32"][kname]},
            **{f: r[f] for f in ("cache_copy_ms", "copy_ms",
                                 "contiguous_copy_ms") if f in r},
            **({"grid": wide["decode_grid"],
                "yardsticks": wide["decode_variants"]}
               if kname == "decode_attention" else {}),
            **({"yardsticks": wide["conv1d_variants"]}
               if kname == "conv1d_causal" else {})})
    eff = models["efficientnetv2_s"]["launches"]
    for kname, src in (("dwconv", "src/repro_torch/kernels/csrc/dwconv.cu"),
                       ("se_gate", "src/repro_torch/kernels/csrc/se.cu"),
                       ("se_scale", "src/repro_torch/kernels/csrc/se.cu")):
        r = eff_kernels[kname]
        line.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": "no TPU kernel", "launches": eff[kname],
            "launches_by_path": {"efficientnetv2_s": eff[kname]},
            **({"staged_launches": eff["se_gate_staged"]}
               if kname == "se_gate" else {}),
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by")},
            "shapes": "the EfficientNetV2-S forward's calls (batch 1, "
                      "384 x 384), fp32, summed"})
    emit({"kernels": line})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
