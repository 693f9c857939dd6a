"""CARLA dual-stationarity GEMM — the paper's 1x1-mode operand swap.

Two CUDA kernels (``csrc/matmul.cu``) compute the same ``(M, C) @ (C, K)``
with the fused flush epilogue, mirroring the paper's §III.B / §III.C
reconfiguration:

* ``matmul_act_stationary`` (§III.B analogue, M >= 128 rows): the C loop
  inside each block; ``act_plan`` picks its block tile, its split of C and
  its gather path (``_build.plan_gemm``).
* ``matmul_weight_stationary`` (§III.C analogue, M < 128 rows): all M rows
  in one row tile, so each weight element is read from device memory by one
  block, once; ``ws_plan`` picks the tile among those, its split of C and
  its gather path (``_build.plan_weight_stationary``).

Both run the pipelined loop of ``csrc/gemm_pipe.cuh`` as a 1x1 conv, one
launch a call: splits of C are combined in the same launch.

``matmul`` picks the variant via ``core.modes.select_stationarity`` — the
software twin of CARLA's controller — unless given a stationarity.  Every
launch takes the planner's plan, or the tile and split count of a tuned
entry (``tiles``, a ``core.autotune.TileConfig``): that plan is checked as
the C side checks it and raises if the launch cannot take it.

``x`` is either a plain ``(M, C)`` matrix or an NHWC ``(B, H, W, C)`` tensor
read at ``stride``: then row m is pixel ``(b, oh*stride, ow*stride)`` and the
result is ``(B, OH, OW, K)``.  The kernels fold the stride into their row
addressing, so a strided 1x1 conv never materialises ``x[:, ::s, ::s]``.

``matmul_plain`` is the plain PyTorch version of both.  A tensor on the CPU
takes it; a CUDA tensor launches the kernel or raises.  Each wrapper's
``launches`` attribute counts launches.

Forward only: no training path reaches these kernels (the CNN forwards
run them), and their outputs carry no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.modes import Stationarity, select_stationarity
from . import _build
from .ref import conv1x1_ref, matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I] + [_P] * 8 + [_I] * 13 + [_P]
_SIGNATURES = {"carla_mm_act_stationary": _ARGS,
               "carla_mm_weight_stationary": _ARGS}


def _rows(x: torch.Tensor, stride: int):
    """(M, C, H, W, OH, OW, output shape) of the GEMM view of x."""
    if x.ndim == 2:
        if stride != 1:
            raise ValueError("a stride needs an NHWC (B, H, W, C) input")
        m, c = x.shape
        return m, c, 1, 1, 1, 1, None
    b, h, wd, c = x.shape
    oh, ow = -(-h // stride), -(-wd // stride)
    return b * oh * ow, c, h, wd, oh, ow, (b, oh, ow)


def matmul_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 scale=None, bias=None, relu: bool = False,
                 residual=None) -> torch.Tensor:
    """The kernels' function in plain PyTorch (fp32 accumulation, x's dtype)."""
    if x.ndim == 2:
        y = matmul_ref(x, w, scale=scale, bias=bias, relu=relu,
                       residual=residual)
    else:
        y = conv1x1_ref(x, w, stride, scale=scale, bias=bias, relu=relu,
                        residual=residual)
    return y.to(x.dtype)


def _check(fn: str, x, w, stride, scale, bias, residual):
    """(M, C, K, H, W, OH, OW, code, scale, bias, empty output) of a launch."""
    m, c, h, wd, oh, ow, lead = _rows(x, stride)
    c2, k = w.shape
    if c != c2:
        raise ValueError(f"{fn}: x has {c} channels, w expects {c2}")
    out_shape = (m, k) if lead is None else (*lead, k)
    code, sc, bi = _build.launch_operands(fn, x, w, out_shape, scale, bias,
                                          residual)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    return m, c, k, h, wd, oh, ow, code, sc, bi, out


def _plan(planner, x, w, stride, residual, n_sms, tiles) -> _build.GemmPlan:
    m, c = _rows(x, stride)[:2]
    k = w.shape[1]
    vec = _build.vec_path(c, k, x, w, residual)
    if tiles is not None:
        return _build.fixed_plan(tiles.tile, tiles.splits, c, vec)
    return planner(m, k, c, n_sms or _build.sm_count(x.device), vec)


def act_plan(x, w, *, stride: int = 1, residual=None,
             n_sms: int | None = None, tiles=None) -> _build.GemmPlan:
    """Tile, split and gather path of the act-stationary launch for these
    operands (on x's device, or on a card of ``n_sms`` SMs; or the tuned
    ``tiles``)."""
    return _plan(_build.plan_gemm, x, w, stride, residual, n_sms, tiles)


def ws_plan(x, w, *, stride: int = 1, residual=None,
            n_sms: int | None = None, tiles=None) -> _build.GemmPlan:
    """Tile, split and gather path of the weight-stationary launch for these
    operands (on x's device, or on a card of ``n_sms`` SMs; or the tuned
    ``tiles``)."""
    return _plan(_build.plan_weight_stationary, x, w, stride, residual,
                 n_sms, tiles)


def _launch(wrapper, entry: str, planner, x, w, stride, scale, bias, relu,
            residual, tiles) -> torch.Tensor:
    """Check the operands, plan with ``planner`` (or take ``tiles``),
    launch ``entry`` and count the launch on ``wrapper``."""
    fn = wrapper.__name__
    m, c, k, h, wd, oh, ow, code, sc, bi, out = _check(
        fn, x, w, stride, scale, bias, residual)
    plan = _plan(planner, x, w, stride, residual, None, tiles)
    ws, tickets = _build.pipe_workspace(x, plan, m, k)
    lib = _build.load("matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            code, x.data_ptr(), w.data_ptr(), _build.ptr(sc), _build.ptr(bi),
            _build.ptr(residual), out.data_ptr(), _build.ptr(ws),
            _build.ptr(tickets), m, c, k, h, wd, stride, oh, ow, plan.tile,
            int(plan.vec), plan.splits, plan.per, int(relu),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn)
    wrapper.launches += 1
    return out


def matmul_act_stationary(x: torch.Tensor, w: torch.Tensor, *,
                          stride: int = 1,
                          scale: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None,
                          relu: bool = False,
                          residual: torch.Tensor | None = None,
                          tiles=None) -> torch.Tensor:
    """(M, C) @ (C, K) with the fused flush; pipelined tiles, C looped
    inside each block."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, stride=stride, scale=scale, bias=bias,
                            relu=relu, residual=residual)
    return _launch(matmul_act_stationary, "carla_mm_act_stationary",
                   _build.plan_gemm, x, w, stride, scale, bias, relu,
                   residual, tiles)


def matmul_weight_stationary(x: torch.Tensor, w: torch.Tensor, *,
                             stride: int = 1,
                             scale: torch.Tensor | None = None,
                             bias: torch.Tensor | None = None,
                             relu: bool = False,
                             residual: torch.Tensor | None = None,
                             tiles=None) -> torch.Tensor:
    """(M, C) @ (C, K) for small M: every weight element is read once."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, stride=stride, scale=scale, bias=bias,
                            relu=relu, residual=residual)
    return _launch(matmul_weight_stationary, "carla_mm_weight_stationary",
                   _build.plan_weight_stationary, x, w, stride, scale, bias,
                   relu, residual, tiles)


matmul_act_stationary.launches = 0
matmul_weight_stationary.launches = 0


def gemm_rows(x: torch.Tensor, stride: int = 1) -> int:
    """M of the GEMM view: the rows of x, or its pixels read at stride."""
    return _rows(x, stride)[0]


def matmul(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           stationarity: Stationarity | None = None, tiles=None,
           **epilogue) -> torch.Tensor:
    """CARLA-style reconfigurable GEMM: pick residency from the M extent
    (unless given), launch with the planner's plan or the tuned ``tiles``."""
    if stationarity is None:
        stationarity = select_stationarity(gemm_rows(x, stride))
    if stationarity == Stationarity.WEIGHT_STATIONARY:
        return matmul_weight_stationary(x, w, stride=stride, tiles=tiles,
                                        **epilogue)
    return matmul_act_stationary(x, w, stride=stride, tiles=tiles,
                                 **epilogue)
