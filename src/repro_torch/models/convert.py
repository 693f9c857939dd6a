"""Carry parameters across: nested dicts of numpy arrays -> dicts of tensors.

The JAX package and this one use the same layouts (HWIO conv weights,
``(C, K)`` 1x1 weights, ``(K,)`` BN vectors, ``(C, classes)`` fc; the LMs'
``(d_in, d_out)`` dense weights, stacked over a leading group axis), and the
same nested-dict keys, so nothing is transposed.  The two packages' random
generators never agree, so parity between them always goes through here:
``params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))``.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import with_compute_copies


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA without a card raises.

    Entry points default to ``"cuda"`` and never fall back to the CPU
    quietly: a run on the CPU is asked for with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device "
                           "is available; pass device='cpu' to run on the CPU")
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, *, device="cuda",
                      dtype: torch.dtype | None = None):
    """A nested dict of numpy arrays -> the same dict of tensors on ``device``.

    ``dtype`` converts every leaf (None keeps each array's own dtype).
    """
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))   # a writable, contiguous copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree_map(leaf, tree)


def lm_params_from_numpy(tree, *, device="cuda"):
    """``repro.models.lm.init_params``'s pytree, as numpy -> the port's LM
    parameters on ``device``.

    The structure is kept as it is: ``blocks/p<i>`` leaves keep their
    leading group axis, ``shared_attn`` and ``embed`` their own shapes.
    Leaves stay fp32 (the master dtype), and every dense weight and the
    embedding table gain a bf16 copy (``layers.with_compute_copies``).
    """
    missing = {"embed", "final_norm", "blocks"} - set(tree)
    if missing:
        raise ValueError(f"lm_params_from_numpy: not an LM pytree, missing "
                         f"{sorted(missing)}")
    return with_compute_copies(params_from_numpy(tree, device=device,
                                                 dtype=torch.float32))
