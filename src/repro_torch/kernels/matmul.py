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

``matmul`` takes the route of ``core.autotune.decide`` (a given
stationarity, else the tuned ``tiles``', else the rule on the rows); each
wrapper names its own.  The launch takes the route's planner's plan or the
tile and split count of ``tiles``, checked as the C side checks it: a plan
the launch cannot take raises.  ``launch`` runs a plan made beforehand.

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

from ..core import autotune
from ..core.modes import Stationarity
from . import _build
from .ref import conv1x1_ref, matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I] + [_P] * 8 + [_I] * 13 + [_P]
_SIGNATURES = {"carla_mm_act_stationary": _ARGS,
               "carla_mm_weight_stationary": _ARGS}


def matmul_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 scale=None, bias=None, relu: bool = False,
                 residual=None, silu: bool = False) -> torch.Tensor:
    """The kernels' function in plain PyTorch (fp32 accumulation, x's dtype)."""
    if x.ndim == 2:
        y = matmul_ref(x, w, scale=scale, bias=bias, relu=relu,
                       residual=residual, silu=silu)
    else:
        y = conv1x1_ref(x, w, stride, scale=scale, bias=bias, relu=relu,
                        residual=residual, silu=silu)
    return y.to(x.dtype)


def _plan(st: Stationarity, x, w, stride, residual, n_sms, tiles):
    d = autotune.decide(x.shape, w.shape, stride, stationarity=st,
                        tiles=tiles, cache=False)
    return autotune.launch_plan(d, x, w, residual, n_sms)


def act_plan(x, w, *, stride: int = 1, residual=None,
             n_sms: int | None = None, tiles=None) -> _build.GemmPlan:
    """Tile, split and gather path of the act-stationary launch for these
    operands (on x's device, or on a card of ``n_sms`` SMs; or the tuned
    ``tiles``)."""
    return _plan(Stationarity.ACTIVATION_STATIONARY, x, w, stride, residual,
                 n_sms, tiles)


def ws_plan(x, w, *, stride: int = 1, residual=None,
            n_sms: int | None = None, tiles=None) -> _build.GemmPlan:
    """Tile, split and gather path of the weight-stationary launch for these
    operands (on x's device, or on a card of ``n_sms`` SMs; or the tuned
    ``tiles``)."""
    return _plan(Stationarity.WEIGHT_STATIONARY, x, w, stride, residual,
                 n_sms, tiles)


def launch(route: str, x, w, plan: _build.GemmPlan, *, stride: int = 1,
           scale=None, bias=None, relu: bool = False,
           residual=None, silu: bool = False) -> torch.Tensor:
    """Check the operands, launch ``route``'s entry point under ``plan``
    and count the launch on the route's wrapper.  ``silu`` takes the
    kernel's SiLU instance."""
    wrapper = _WRAPPERS[route]
    fn = wrapper.__name__
    m, c, h, wd, oh, ow, lead = _build.gemm_view(x.shape, stride)
    c2, k = w.shape
    if c != c2:
        raise ValueError(f"{fn}: x has {c} channels, w expects {c2}")
    out_shape = (m, k) if lead is None else (*lead, k)
    code, sc, bi = _build.launch_operands(fn, x, w, out_shape, scale, bias,
                                          residual)
    if relu and silu:
        raise ValueError(f"{fn}: ReLU or SiLU, not both")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    ws, tickets = _build.pipe_workspace(x, plan, m, k)
    r = _build.ROUTES[route]
    lib = _build.load(r.lib, _SIGNATURES)
    with torch.cuda.device(x.device):
        _build.launch(getattr(lib, r.entry), (
            code, x.data_ptr(), w.data_ptr(), _build.ptr(sc), _build.ptr(bi),
            _build.ptr(residual), out.data_ptr(), _build.ptr(ws),
            _build.ptr(tickets), m, c, k, h, wd, stride, oh, ow, plan.tile,
            int(plan.vec), plan.splits, plan.per, 2 if silu else int(relu),
            torch.cuda.current_stream().cuda_stream), fn, route)
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
    return matmul(x, w, stride=stride, scale=scale, bias=bias, relu=relu,
                  residual=residual, tiles=tiles,
                  stationarity=Stationarity.ACTIVATION_STATIONARY)


def matmul_weight_stationary(x: torch.Tensor, w: torch.Tensor, *,
                             stride: int = 1,
                             scale: torch.Tensor | None = None,
                             bias: torch.Tensor | None = None,
                             relu: bool = False,
                             residual: torch.Tensor | None = None,
                             tiles=None) -> torch.Tensor:
    """(M, C) @ (C, K) for small M: every weight element is read once."""
    return matmul(x, w, stride=stride, scale=scale, bias=bias, relu=relu,
                  residual=residual, tiles=tiles,
                  stationarity=Stationarity.WEIGHT_STATIONARY)


matmul_act_stationary.launches = 0
matmul_weight_stationary.launches = 0
_WRAPPERS = {autotune.MM_AS: matmul_act_stationary,
             autotune.MM_WS: matmul_weight_stationary}


def gemm_rows(x: torch.Tensor, stride: int = 1) -> int:
    """M of the GEMM view: the rows of x, or its pixels read at stride."""
    return _build.gemm_view(x.shape, stride)[0]


def matmul(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           stationarity: Stationarity | None = None, tiles=None,
           **epilogue) -> torch.Tensor:
    """CARLA-style reconfigurable GEMM on the route of ``autotune.decide``
    (``stationarity``, else the tuned ``tiles``', else the rows'), under
    its planner's plan or ``tiles``."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, stride=stride, **epilogue)
    d = autotune.decide(x.shape, w.shape, stride, stationarity=stationarity,
                        tiles=tiles, cache=False)
    return launch(d.route, x, w,
                  autotune.launch_plan(d, x, w, epilogue.get("residual")),
                  stride=stride, **epilogue)
