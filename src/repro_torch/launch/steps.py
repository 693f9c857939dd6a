"""Step functions (port of ``repro.launch.steps``): the train step.

``make_train_step`` returns ``{"fn", "opt", "make_init"}``: ``fn(state,
batch) -> (state, {"loss", "step"})`` differentiates ``lm.loss_fn`` with
autograd and applies the optimizer in place; the train state is the dict
``{"params", "opt", "step"}``, as in ``repro``, so checkpoints carry the same
leaves.  ``impl`` and ``dtype`` pass through to the model, as in
``lm.prefill``.  Not ported yet (ROADMAP.md): ``input_specs`` and the
sharded ``jit`` halves, ``make_prefill`` and ``make_decode_step`` (serving
calls ``lm.prefill`` and ``lm.decode_step`` directly).
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..models.convert import resolve_device
from ..optim import make_optimizer
from ..pytree import flatten, unflatten


# ------------------------------ train step -----------------------------------
def make_train_step(cfg: ModelConfig, optimizer_name: str = "adamw",
                    lr=3e-4, *, impl: str = "auto",
                    dtype=lm.COMPUTE_DTYPE, device="cuda") -> dict:
    dev = resolve_device(device)
    opt = make_optimizer(optimizer_name, lr)

    def train_step(state, batch):
        params = state["params"]
        leaves, treedef = flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = lm.loss_fn(cfg, params, batch, impl=impl, dtype=dtype)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = unflatten(treedef, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
        new_params, new_opt = opt.update(grads, state["opt"], params)
        step = state["step"] + 1
        return ({"params": new_params, "opt": new_opt, "step": step},
                {"loss": loss.detach(), "step": step})

    def make_init(seed: int = 0):
        def init():
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = lm.init_params(cfg, gen, device=dev)
            return {"params": params, "opt": opt.init(params),
                    "step": torch.zeros((), dtype=torch.int32, device=dev)}
        return init

    return {"fn": train_step, "opt": opt, "make_init": make_init}
