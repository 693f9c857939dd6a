"""Build the CUDA kernels with ``nvcc`` at first use, load them with ctypes,
and check the operands a launch is given.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so``, a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  All sources are compiled together, one ``nvcc`` process each, into
``_build/<hash>/`` beside this file, where the hash covers every source,
header and flag: a second run with the same sources loads what is there.
The build directory is listed in ``.gitignore``.

Nothing here runs at import time; the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under $CUDA_HOME/bin)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash(names=None) -> str:
    """Hash of the nvcc flags and the named ``csrc/`` files (default: every
    source and header, the build directory's hash)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = (sorted(CSRC.glob("*.cu*")) if names is None
             else [CSRC / n for n in sorted(names)])
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> float:
    """Compile every source that is not built yet, all in parallel.

    Returns the seconds spent (0.0 when everything was already built).  The
    compiler's output, including ``-Xptxas -v`` register and spill counts,
    goes to ``<build_dir>/<name>.log``.  Raises if any source fails.
    """
    out = build_dir()
    todo = [s for s in sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        # Build under a temporary name, then rename: a concurrent build of
        # the same hash never sees a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        log = open(out / f"{src.stem}.log", "w")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                                 str(src)], stdout=log,
                                stderr=subprocess.STDOUT)
        procs.append((src, tmp, log, proc))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out / f"lib{src.stem}.so")
        else:
            os.unlink(tmp)
            failed.append(f"{src.name} (see {out / (src.stem + '.log')})")
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}")
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler output of ``csrc/<name>.cu`` from its last build."""
    p = build_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load ``lib<name>.so`` (building first if needed).

    ``signatures`` maps each C entry point to its ctypes argument types.
    Every pointer and the stream must be ``ctypes.c_void_p``: left
    undeclared, ctypes would pass a Python int as a 32-bit C int and cut
    the pointer.  Every entry point returns ``cudaGetLastError()``.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the C side's `dtype`


def launch_operands(what: str, x, w, out_shape: tuple, scale, bias,
                    residual):
    """Check a kernel's operands; return (dtype code, fp32 scale, fp32 bias).

    x and w must be contiguous CUDA tensors of one supported dtype; the
    residual, when given, a contiguous tensor of the output's shape and
    x's dtype; scale/bias (K,) vectors on the same device (cast to fp32).
    The kernels take sizes and row indices as 32-bit ints, so the output
    must hold fewer than 2**31 elements.  Raises on anything the kernel does
    not take.
    """
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, x is on "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        f"(have {list(DTYPE_CODES)})")
    for name, t in (("w", w), ("residual", residual)):
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, "
                            f"x is {x.dtype} on {x.device}")
    for name, t in (("x", x), ("w", w), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if math.prod(out_shape) >= 2 ** 31:
        raise ValueError(f"{what}: output {tuple(out_shape)} has 2**31 or "
                         "more elements")
    if residual is not None and tuple(residual.shape) != tuple(out_shape):
        raise ValueError(f"{what}: residual shape {tuple(residual.shape)} != "
                         f"output shape {tuple(out_shape)}")
    vecs = []
    for name, v in (("scale", scale), ("bias", bias)):
        if v is not None:
            if v.device != x.device or tuple(v.shape) != (out_shape[-1],):
                raise ValueError(f"{what}: {name} must be ({out_shape[-1]},) "
                                 f"on {x.device}, got {tuple(v.shape)} on "
                                 f"{v.device}")
            v = v.float().contiguous()
        vecs.append(v)
    return DTYPE_CODES[x.dtype], vecs[0], vecs[1]


def attention_operands(what: str, **tensors) -> int:
    """Check the attention kernels' tensors; return their dtype code.

    Every tensor must be a contiguous, 16-byte aligned CUDA tensor (the
    kernels read rows with 16-byte vector loads) of fewer than 2**31
    elements, all of one supported dtype.  Raises on anything else.
    """
    first_name, first = next(iter(tensors.items()))
    if first.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, "
                         f"{first_name} is on {first.device}")
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {first.dtype} not supported "
                        f"(have {list(DTYPE_CODES)})")
    for name, t in tensors.items():
        if t.device != first.device or t.dtype != first.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, "
                            f"{first_name} is {first.dtype} on "
                            f"{first.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{what}: {name} has 2**31 or more elements")
    return DTYPE_CODES[first.dtype]


MIN_CHUNKS_PER_SPLIT = 4    # a split reduces at least 4 chunks of PIPE_BK


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---- the pipelined CNN loop of csrc/gemm_pipe.cuh (conv2d, both 1x1 GEMMs)
PIPE_BK = 16                 # PIPE_BK: reduction indices a chunk
PIPE_STAGES = 3              # PIPE_STAGES: slots in the shared-memory ring
PIPE_TABLE_MAX = 2048        # PIPE_TABLE_MAX: general path, indices a split
# (BM, BN, G) by tile code: block tile and groups of threads splitting each
# slot's chunks (csrc/gemm_pipe.cuh: PipeM, PipeS, PipeG)
PIPE_TILES = ((128, 64, 1), (64, 64, 1), (64, 64, 4))
REFERENCE_SMS = 132          # H100 SXM: the SMs tile_util is reported for
# The planner's latency model of a launch, in SM cycles, its constants
# fitted to the H100's times of every main-path layer under every plan
# (PERF.md, PR 14): a thread's 8x8 tile does 1024 FMAs a chunk; a warp
# issues at most PIPE_WARP_RATE of them a cycle and a scheduler at most its
# tile's PIPE_SCHED_RATE over its warps; as many blocks sit on an SM as its
# registers hold at 170 a thread; a split costs its tile's last block one
# L2 round trip per G splits, and every block PIPE_START cycles.
PIPE_WARP_RATE = 0.35
PIPE_SCHED_RATE = (0.6, 0.56, 0.56)
PIPE_L2_TRIP = 1000
PIPE_START = 4000


class GemmPlan(NamedTuple):
    tile: int      # the C side's tile code, an index into PIPE_TILES
    bm: int
    bn: int
    groups: int    # G: groups of threads splitting each slot's chunks
    splits: int    # grid z: splits of the reduction
    per: int       # reduction indices a split (a multiple of PIPE_BK)
    vec: bool      # the vec16 gather path; else the general one

    @property
    def path(self) -> str:
        return "vec16" if self.vec else "general"

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.bm) * -(-n // self.bn)


def pipe_cycles(m: int, n: int, plan: GemmPlan, n_sms: int) -> float:
    """The latency model's SM cycles for one launch under ``plan``."""
    threads = plan.groups * plan.bm * plan.bn // 64
    resident = max(1, 65536 // (threads * 170))
    per_sm = -(-plan.tiles(m, n) * plan.splits // n_sms)
    waves = -(-per_sm // resident)
    sched_warps = min(resident, per_sm) * threads / 32 / 4
    rate = min(PIPE_WARP_RATE, PIPE_SCHED_RATE[plan.tile] / sched_warps)
    chunks = -(-plan.per // PIPE_BK)
    block = -(-chunks // plan.groups) * 1024 / rate + PIPE_START
    combine = (-(-plan.splits // plan.groups) * PIPE_L2_TRIP
               if plan.splits > 1 else 0)
    return waves * block + combine


def split_plan(tile: int, splits: int, reduction: int,
               vec: bool) -> GemmPlan | None:
    """Tile ``tile`` with the reduction cut into ``splits`` splits of whole
    PIPE_BK chunks, or None where no cut gives exactly that many or, on the
    general path, a split would hold more than PIPE_TABLE_MAX indices (the
    launches the C side refuses)."""
    chunks = max(1, -(-reduction // PIPE_BK))
    per = -(-chunks // splits) * PIPE_BK
    if max(1, -(-reduction // per)) != splits or (
            not vec and min(per, reduction) > PIPE_TABLE_MAX):
        return None
    bm, bn, groups = PIPE_TILES[tile]
    return GemmPlan(tile, bm, bn, groups, splits, per, vec)


def pipe_plans(reduction: int, vec: bool, codes):
    """Every plan of the tiles in ``codes`` whose splits hold at least
    MIN_CHUNKS_PER_SPLIT chunks each (or one split), in code order, then
    split count."""
    chunks = max(1, -(-reduction // PIPE_BK))
    for code in codes:
        for want in range(1, max(1, chunks // MIN_CHUNKS_PER_SPLIT) + 1):
            plan = split_plan(code, want, reduction, vec)
            if plan is not None:
                yield plan


def fixed_plan(tile: int, splits: int, reduction: int,
               vec: bool) -> GemmPlan:
    """The plan a caller names (a tuned entry), checked as the C side
    checks it; raises ValueError for one the launch cannot take."""
    if not 0 <= tile < len(PIPE_TILES) or splits < 1:
        raise ValueError(f"no pipelined plan has tile {tile}, {splits} "
                         "splits")
    plan = split_plan(tile, splits, reduction, vec)
    if plan is None:
        raise ValueError(
            f"a reduction of {reduction} cannot take {splits} splits of "
            f"whole {PIPE_BK}-index chunks on the "
            f"{'vec16' if vec else 'general'} path")
    return plan


def ws_codes(m: int) -> list[int]:
    """The tiles that hold m rows in the fewest row tiles, smallest first:
    the weight-stationary plan's choice, so that each weight element is
    read from device memory by one block (by ceil(m / 128) above 128
    rows)."""
    fewest = min(-(-max(m, 1) // bm) for bm, _, _ in PIPE_TILES)
    return [code for code in reversed(range(len(PIPE_TILES)))
            if -(-max(m, 1) // PIPE_TILES[code][0]) == fewest]


def _least_cycles(m: int, n: int, reduction: int, n_sms: int, vec: bool,
                  codes) -> GemmPlan:
    """Of ``pipe_plans``, the plan with the least modelled time
    (``pipe_cycles``); ties go to the earlier one."""
    return min(pipe_plans(reduction, vec, codes),
               key=lambda plan: pipe_cycles(m, n, plan, n_sms))


@functools.lru_cache(maxsize=4096)
def plan_gemm(m: int, n: int, reduction: int, n_sms: int,
              vec: bool) -> GemmPlan:
    """Block tile, groups and split of an (m, n) output over ``reduction``
    (conv2d, act-stationary): the least modelled time over every tile.
    Ties go to the smaller tile."""
    return _least_cycles(m, n, reduction, n_sms, vec,
                         reversed(range(len(PIPE_TILES))))


@functools.lru_cache(maxsize=4096)
def plan_weight_stationary(m: int, n: int, c: int, n_sms: int,
                           vec: bool) -> GemmPlan:
    """The weight-stationary plan of an (m, c) @ (c, n) product: the least
    modelled time over ``ws_codes(m)``, the tiles that hold the rows in the
    fewest row tiles (all of them in one for m <= 128)."""
    return _least_cycles(m, n, c, n_sms, vec, ws_codes(m))


def vec_path(c: int, k: int, x, w, residual) -> bool:
    """Whether a launch may take the vec16 path: C a multiple of PIPE_BK,
    K a whole number of 16-byte vectors, x, w and the residual (or None)
    16-byte aligned."""
    return (c % PIPE_BK == 0 and k * x.element_size() % 16 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and (residual is None or residual.data_ptr() % 16 == 0))


# Per device, scratch of the kernels that combine splits in the launch
# (decode attention and the pipelined CNN kernels), allocated once and
# grown when a call needs more: int32 ticket counters, 0 before and after
# every call, and the CNN kernels' fp32 partial sums.  Calls that share them
# must be ordered on one stream.
_tickets: dict = {}
_partials: dict = {}


def ticket_counters(device, n: int) -> torch.Tensor:
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = _tickets[device] = torch.zeros(max(n, 1), dtype=torch.int32,
                                             device=device)
    return buf


def pipe_workspace(x, plan: GemmPlan, m: int, n: int):
    """(fp32 workspace or None, ticket counters or None) of a pipelined
    launch: one BM x BN slice per (split, output tile), one counter a tile."""
    if plan.splits == 1:
        return None, None
    tiles = plan.tiles(m, n)
    need = plan.splits * tiles * plan.bm * plan.bn
    ws = _partials.get(x.device)
    if ws is None or ws.numel() < need:
        ws = _partials[x.device] = torch.empty(need, dtype=torch.float32,
                                               device=x.device)
    return ws, ticket_counters(x.device, tiles)


def check(err: int, what: str) -> None:
    """Raise if a kernel's launch failed (``cudaGetLastError() != 0``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()
