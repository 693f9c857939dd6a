"""The comparison that decides ``correct``.

Every image a window answered is held to the plain reference's logits for
the same input: its widest gap from them, as a share of the reference's
largest logit of that image.  An answer that is not finite reads inf.
"""
from __future__ import annotations

import torch


def image_errors(answers: torch.Tensor, n_slots: int, want: torch.Tensor,
                 batch: int) -> torch.Tensor:
    """answers: (steps, batch, classes) on the host, step i answering slot
    i % n_slots, whose images are the pool's i % n_slots * batch onward;
    want: the reference's logits of the whole pool.  One error per image.
    """
    errs = []
    for k in range(min(n_slots, len(answers))):
        got = answers[k::n_slots].float()
        ref = want[k * batch:(k + 1) * batch].float()
        err = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
        bad = ~torch.isfinite(got).all(-1) | torch.isnan(err)
        errs.append(torch.where(bad, torch.inf, err).flatten())
    return torch.cat(errs) if errs else torch.empty(0)
