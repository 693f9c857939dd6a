"""Optimizers from scratch: AdamW, Adafactor, Lion, SGD-momentum (port of
``repro.optim.optimizers``).

The functional API is ``repro``'s: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (params, state)``.  Here the update
runs under ``torch.no_grad`` and writes the parameter and moment leaves in
place (``repro`` returns new trees); the returned ``params`` is the same
tree and the state a new NamedTuple over the same moment tensors with the
step advanced.  The states keep ``repro``'s NamedTuples and field order, so a
checkpoint's leaves line up between the packages; the moments keep their
dtypes (Lion's is bf16 by default).  Weight decay applies to every leaf, as
in ``repro``.  ``state_pspec`` gives the state's sharding specs from the
params'; on DTensor leaves placed by them the update runs as written (the
sharded train step calls it under DTensor's implicit replication, so the
0-d step and learning-rate tensors mix with the shards, and the global
norm and Adafactor's means reduce over the shards).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models.convert import resolve_device
from ..pytree import leaves, tree_map

Params = Any


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params) -> torch.Tensor:
    ls = leaves(params)
    dev = ls[0].device if ls else "cpu"
    return torch.zeros((), dtype=torch.int32, device=dev)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# --------------------------------- AdamW --------------------------------------
class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Params
    nu: Params


def adamw(lr: float | Callable = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0, moment_dtype=torch.float32) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return AdamState(_step0(params), tree_map(z, params),
                         tree_map(z, params))

    @torch.no_grad()
    def update(grads, state, params):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state.step + 1
        lr_t = lr_fn(step)
        sf = step.float()
        bc1 = 1 - _f32(b1, sf) ** sf
        bc2 = 1 - _f32(b2, sf) ** sf
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.mu), leaves(state.nu)):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            mhat, vhat = m_new / bc1, v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, AdamState(step, state.mu, state.nu)

    return Optimizer("adamw", init, update)


# ------------------------------- Adafactor ------------------------------------
class FactorState(NamedTuple):
    step: torch.Tensor
    vr: Params   # row stats (param shape minus last axis); scalar v for 1-D
    vc: Params   # col stats (param shape minus 2nd-to-last axis); unused 1-D


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor(lr: float | Callable = 1e-3, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def vr(p):
            shape = p.shape[:-1] if _factored(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc(p):
            shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return FactorState(_step0(params), tree_map(vr, params),
                           tree_map(vc, params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        beta = 1.0 - (step.float() + 1.0) ** -decay
        lr_t = lr_fn(step)
        for p, g, vr, vc in zip(leaves(params), leaves(grads),
                                leaves(state.vr), leaves(state.vc)):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p):
                vr_new = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                vc_new = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = vr_new / torch.mean(vr_new, dim=-1, keepdim=True)
                u = gf * torch.rsqrt(rfac + eps)[..., None] * \
                    torch.rsqrt(vc_new + eps)[..., None, :]
            else:
                vr_new = beta * vr + (1 - beta) * g2
                vc_new = vc
                u = gf * torch.rsqrt(vr_new)
            # update clipping (RMS <= clip_threshold)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            p.copy_(pf - lr_t * (u + weight_decay * pf))
            vr.copy_(vr_new)
            vc.copy_(vc_new)
        return params, FactorState(step, state.vr, state.vc)

    return Optimizer("adafactor", init, update)


# --------------------------------- Lion ---------------------------------------
class LionState(NamedTuple):
    step: torch.Tensor
    mu: Params


def lion(lr: float | Callable = 1e-4, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.1, grad_clip: float = 1.0,
         moment_dtype=torch.bfloat16) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return LionState(_step0(params), tree_map(
            lambda p: torch.zeros_like(p, dtype=moment_dtype), params))

    @torch.no_grad()
    def update(grads, state, params):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state.step + 1
        lr_t = lr_fn(step)
        for p, g, m in zip(leaves(params), leaves(grads), leaves(state.mu)):
            gf, mf, pf = g.float(), m.float(), p.float()
            update_dir = torch.sign(b1 * mf + (1 - b1) * gf)
            p.copy_(pf - lr_t * (update_dir + weight_decay * pf))
            m.copy_(b2 * mf + (1 - b2) * gf)
        return params, LionState(step, state.mu)

    return Optimizer("lion", init, update)


# ----------------------------- SGD momentum -----------------------------------
def sgdm(lr: float | Callable = 1e-2, momentum: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return LionState(_step0(params), tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        for p, g, m in zip(leaves(params), leaves(grads), leaves(state.mu)):
            m.copy_(momentum * m + g.float())
            p.copy_(p.float() - lr_t * m)
        return params, LionState(step, state.mu)

    return Optimizer("sgdm", init, update)


# ------------------------- sharding of optimizer state ------------------------
def _map2(fn, specs, params):
    if isinstance(params, dict):
        return {k: _map2(fn, specs[k], v) for k, v in params.items()}
    return fn(specs, params)


def state_pspec(opt_name: str, param_spec_tree, params):
    """The optimizer state's spec tree (specs as in ``launch.sharding``)
    from the params' and the params (tensors, or anything with a shape).

    Adam/Lion/SGD-momentum moments share the param spec; Adafactor's
    factored statistics drop the reduced axis from it.  ZeRO sharding by
    construction."""
    scalar = ()
    if opt_name == "adamw":
        return AdamState(scalar, param_spec_tree, param_spec_tree)
    if opt_name in ("lion", "sgdm"):
        return LionState(scalar, param_spec_tree)
    if opt_name == "adafactor":
        def pad(spec, p):
            return tuple(spec) + (None,) * (len(p.shape) - len(spec))

        vr = _map2(lambda sp, p: pad(sp, p)[:-1] if _factored(p) else sp,
                   param_spec_tree, params)
        vc = _map2(lambda sp, p: pad(sp, p)[:-2] + pad(sp, p)[-1:]
                   if _factored(p) else (), param_spec_tree, params)
        return FactorState(scalar, vr, vc)
    raise ValueError(opt_name)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "lion": lion,
              "sgdm": sgdm}
STATES = {"AdamState": AdamState, "FactorState": FactorState,
          "LionState": LionState}


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    return OPTIMIZERS[name](lr=lr, **kw)


def _leaf_from_numpy(a, dev) -> torch.Tensor:
    """An array (numpy, or a jax array via ``np.asarray``) as a tensor on
    dev; bf16 (``ml_dtypes``' dtype, which torch does not read) crosses as
    its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def opt_state_from_numpy(state, *, device="cuda"):
    """``repro``'s optimizer state (``AdamState``, ``FactorState`` or
    ``LionState`` of numpy trees, or of jax arrays) -> the port's NamedTuple
    of the same name and fields, as tensors on ``device``, dtypes kept;
    ``models.convert.to_numpy`` goes back."""
    dev = resolve_device(device)
    cls = STATES.get(type(state).__name__)
    if cls is None or tuple(cls._fields) != tuple(state._fields):
        raise ValueError(f"opt_state_from_numpy: not an optimizer state: "
                         f"{type(state).__name__}")
    return cls(*(tree_map(lambda a: _leaf_from_numpy(a, dev), f)
                 for f in state))
