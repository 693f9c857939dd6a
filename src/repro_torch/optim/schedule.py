"""Learning-rate schedules: callables of the int32 step tensor, returning
an fp32 0-d tensor on the step's device (port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = peak * s / max(1, warmup_steps)
        prog = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac * peak + (1 - final_frac) * peak * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


def inverse_sqrt(peak: float, warmup_steps: int):
    def fn(step):
        s = torch.clamp(step.float(), min=1.0)
        warm = peak * s / max(1, warmup_steps)
        decay = peak * (warmup_steps ** 0.5) / torch.sqrt(s)
        return torch.where(s < warmup_steps, warm, decay)
    return fn
