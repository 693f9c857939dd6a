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
import torch.utils.checkpoint

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


_CHECKPOINTED: contextvars.ContextVar = contextvars.ContextVar(
    "checkpointed", default=False)


def checkpoint(fn, *args):
    """``torch.utils.checkpoint.checkpoint(fn, *args)``, non-reentrant, with
    the region marked for ``scan``: in its forward and in its backward's
    recomputation ``checkpointed()`` is true.  A folded step counts what it
    saves for the backward only while a checkpointed region's backward runs
    (the forward drops it); a region checkpointed by another route counts
    as not checkpointed, its saved tensors in the forward too (an upper
    bound)."""

    def marked(*a):
        tok = _CHECKPOINTED.set(True)
        try:
            return fn(*a)
        finally:
            _CHECKPOINTED.reset(tok)

    return torch.utils.checkpoint.checkpoint(marked, *args,
                                             use_reentrant=False)


def checkpointed() -> bool:
    """Whether the call runs inside ``checkpoint``'s region, its forward or
    its backward's recomputation."""
    return _CHECKPOINTED.get()


class _Folded(torch.autograd.Function):
    """One step counted n times, forward and backward."""

    @staticmethod
    def forward(ctx, n, repeat, step, n_consts, *args):
        ctx.set_materialize_grads(False)
        ctx.n_consts = n_consts
        in_checkpoint = checkpointed()
        saved = []

        def pack(t):
            saved.append(t)
            return t

        # the step's own graph keeps its tensors (an outer checkpoint's
        # hooks must not pack them)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                pack, lambda t: t):
            ins = [a.detach().requires_grad_(a.requires_grad) for a in args]
            # a carry inside the loop depends on the steps before it
            ins[0].requires_grad_(any(a.requires_grad for a in args))
            ctx.carry_needs_grad = args[0].requires_grad
            with repeat(n) as resident:
                carry, y = step(*ins)
                y_out = y.detach()
                # what each unrolled step leaves alive: its output slice
                # until the stack is made, the tensors its backward saved
                # (not the loop's own slices of xs and constants) and its
                # carry, which the next step saves
                ins_ids = {id(a) for a in ins}
                kept = {id(b): b for b in (
                    t if t._base is None else t._base for t in saved)
                    if id(b) not in ins_ids}
                if carry.requires_grad:
                    kept[id(carry)] = carry
                ctx.step_bytes = sum(t.numel() * t.element_size()
                                     for t in kept.values())
                # a checkpointed forward keeps none of them (the backward
                # recomputes them), nor does a forward without a backward:
                # then the last step runs beside the carry of the step
                # before it
                ctx.checkpointed = in_checkpoint and carry.requires_grad
                if carry.requires_grad and not in_checkpoint:
                    resident(y_out, *kept.values())
                else:
                    resident(y_out, during_bytes=carry.numel()
                             * carry.element_size())
        ctx.n, ctx.repeat, ctx.ins, ctx.outs = n, repeat, ins, (carry, y)
        carry_out = carry.detach()
        # a detached view shares its tensor's storage: keep the tensors the
        # counter tracks alive as long as the views the loop returns
        carry_out._traced, y_out._traced = carry, y
        return carry_out, y_out

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
            with ctx.repeat(ctx.n) as resident:
                if ctx.checkpointed:
                    # the checkpoint recomputed the n steps for this
                    # backward: the n - 1 untraced ones hold their saved
                    # tensors while it runs
                    resident(during_bytes=(ctx.n - 1) * ctx.step_bytes)
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
