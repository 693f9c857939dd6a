"""A loop of identical steps over a sequence (``scan``), the counterpart of
``repro``'s ``lax.scan`` for the per-token recurrences, which a cost
counter can fold.

``scan`` runs ``step`` once per position in Python.  Inside ``folding(repeat)``
(``launch.graph_analysis.GraphCounter`` enters it for the dry run, whose
tensors are fake: shapes without values) it runs the step once, inside
``repeat(n)``, which counts its ops n times, and copies that step's
output to every position: the counterpart of ``repro``'s HLO walk
multiplying a ``while`` body by its trip count.  Under autograd the folded
step is a Function whose backward also runs inside ``repeat(n)``.  The
forward's count is the unrolled loop's; the backward's differs by the
slices' and the stacked outputs' gradients (one scatter a sliced input
where the loop stacks T gradients, one sum where it has none) and the
loop's last carry gradient (none there, zeros here).  The folded values
are those of one step, so a folding block must only count, never compute.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_FOLD: contextvars.ContextVar = contextvars.ContextVar("fold", default=None)


@contextlib.contextmanager
def folding(repeat):
    """Inside the block ``scan`` runs one step under ``repeat(n)``."""
    tok = _FOLD.set(repeat)
    try:
        yield
    finally:
        _FOLD.reset(tok)


def scan(step, carry, xs: tuple, consts: tuple = ()):
    """``carry, y = step(carry, *x_i, *consts)`` for x_i the slices of the
    tensors ``xs`` at position i of dim 1, in order.  Returns (the last
    carry, the y's stacked along dim 1)."""
    n = xs[0].shape[1]
    repeat = _FOLD.get()
    if repeat is None or n < 2:
        slices = [x.unbind(1) for x in xs]
        ys = []
        for i in range(n):
            carry, y = step(carry, *(s[i] for s in slices), *consts)
            ys.append(y)
        return carry, torch.stack(ys, dim=1)
    # no per-position views or outputs: a fake tensor costs tens of
    # microseconds each, and T is 32768 in the dry run's prefill cells
    carry, y = _Folded.apply(n, repeat, step, len(consts), carry,
                             *(x.select(1, 0) for x in xs), *consts)
    # the one step's output stands for every position's; the copy moves
    # the stack's bytes
    shape = (y.shape[0], n) + tuple(y.shape[1:])
    return carry, y.unsqueeze(1).expand(shape).contiguous()


class _Folded(torch.autograd.Function):
    """One step counted n times, forward and backward."""

    @staticmethod
    def forward(ctx, n, repeat, step, n_consts, *args):
        ctx.set_materialize_grads(False)
        ctx.n_consts = n_consts
        # the step's own graph keeps its tensors (an outer checkpoint's
        # hooks must not pack them)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            ins = [a.detach().requires_grad_(a.requires_grad) for a in args]
            # a carry inside the loop depends on the steps before it
            ins[0].requires_grad_(any(a.requires_grad for a in args))
            ctx.carry_needs_grad = args[0].requires_grad
            with repeat(n):
                outs = step(*ins)
        ctx.n, ctx.repeat, ctx.ins, ctx.outs = n, repeat, ins, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, carry_grad, y_grad):
        carry, y = ctx.outs
        if carry_grad is None and carry.requires_grad:
            # inside the loop the carry always has a gradient, the next
            # step's: the folded step stands for those steps
            carry_grad = torch.zeros_like(carry)
        pairs = [(o, g) for o, g in ((carry, carry_grad), (y, y_grad))
                 if g is not None and o.requires_grad]
        want = [t for t in ctx.ins if t.requires_grad]
        got = [None] * len(want)
        if pairs and want:
            with ctx.repeat(ctx.n):
                got = torch.autograd.grad(
                    [o for o, _ in pairs], want, [g for _, g in pairs],
                    allow_unused=True)
        it = iter(got)
        out = [next(it) if t.requires_grad else None for t in ctx.ins]
        if not ctx.carry_needs_grad:
            out[0] = None
        # the unrolled loop sums a constant's n per-step gradients: n - 1
        # adds, counted here
        with ctx.repeat(ctx.n - 1):
            for g in out[len(out) - ctx.n_consts:]:
                if g is not None:
                    torch.add(g, g)
        return (None, None, None, None) + tuple(out)
