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
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

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


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
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


MIN_CHUNKS_PER_SPLIT = 4    # a split reduces at least 4 chunks of BK values


def plan_splits(tiles: int, reduction: int, bk: int,
                n_sms: int) -> tuple[int, int]:
    """(splits, reduction per split) for the split reduction (tile_gemm.cuh).

    No split when the output tiles alone fill the SMs.  Otherwise enough
    splits to put about two blocks on every SM, each split a whole number
    of BK chunks and at least MIN_CHUNKS_PER_SPLIT of them.
    """
    chunks = -(-reduction // bk)
    if tiles >= n_sms or chunks < 2 * MIN_CHUNKS_PER_SPLIT:
        return 1, chunks * bk
    want = min(-(-2 * n_sms // tiles), chunks // MIN_CHUNKS_PER_SPLIT)
    per = -(-chunks // want) * bk
    return -(-reduction // per), per


def split_launch(x, tiles: int, reduction: int, bk: int, m: int, k: int):
    """Plan the splits for a launch on x's device; allocate the workspace.

    Returns (splits, reduction per split, fp32 workspace or None).
    """
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per = plan_splits(tiles, reduction, bk, n_sms)
    ws = (torch.empty((splits, m, k), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    return splits, per, ws


def check(err: int, what: str) -> None:
    """Raise if a kernel's launch failed (``cudaGetLastError() != 0``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()
