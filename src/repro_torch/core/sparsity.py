"""Structured (channel) sparsity support — paper §IV.A / Table I.

CARLA benefits from *structured* filter pruning: removing a filter removes an
output channel (and the corresponding input channel of the next layer), so the
dataflow is unchanged and there is no indexing overhead.  This module provides:

  * ``topk_channel_mask`` — deterministic L1-importance keep-masks (stable
    sort, ties broken toward the lower channel index);
  * ``prune_conv_weights`` / ``prune_bn`` — functional pruning of weight
    tensors and their per-channel epilogue operands (folded-BN scale/bias),
    with strict mask validation;
  * ``prune_plan`` — given per-layer keep-fractions and the chain's real
    input-channel count, the pruned channel counts with next-layer
    input-channel propagation (the paper's Table I pattern);
  * ``SparsityTag`` — the dense-twin channel counts a pruned ``carla_conv``
    dispatch carries into its telemetry span, so the measured ledger can
    report keep-fraction and pruned-vs-dense MACs per layer.

Masks are host-side numpy booleans and are computed from the weights' values
in numpy float32, so the same values give the same mask bit for bit whatever
device the weights live on.  The model-level planner that walks a ResNet-50
parameter dict lives in ``models.cnn.resnet50_prune``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .modes import ConvLayer


def channel_importance(w: torch.Tensor) -> np.ndarray:
    """L1 importance per output channel; w: (FL, FL, IC, K) -> (K,).

    Summed in numpy float32 over the tensor's values (copied to the host),
    so the importances — and hence the masks — do not depend on the device's
    reduction order.
    """
    wn = np.asarray(w.detach().float().cpu().numpy(), np.float32)
    return np.sum(np.abs(wn), axis=tuple(range(wn.ndim - 1)))


def topk_channel_mask(w: torch.Tensor, keep_fraction: float) -> np.ndarray:
    """Boolean keep-mask over output channels (static, host-side).

    Deterministic under ties: the sort is stable and descending importance is
    ranked with the channel index as tiebreak, so tied L1 norms (zero-init or
    symmetric weights) always keep the lowest-indexed channels — the same
    mask on every run and platform.
    """
    if not 0.0 < keep_fraction <= 1.0:
        raise ValueError(f"keep_fraction must be in (0, 1], got {keep_fraction}")
    k = w.shape[-1]
    n_keep = max(1, int(round(k * keep_fraction)))
    imp = channel_importance(w)
    # kind="stable" preserves index order among equal importances; a plain
    # introsort would reorder ties nondeterministically across platforms.
    order = np.argsort(-imp, kind="stable")
    keep = np.zeros(k, dtype=bool)
    keep[order[:n_keep]] = True
    return keep


def _validate_mask(mask, dim: int, what: str) -> np.ndarray:
    """A keep-mask must be 1-D boolean of exactly the channel dim it selects.

    Boolean fancy-indexing with a short/long mask would silently drop
    entries; a non-boolean mask would *gather* instead of select.  Both are
    data-corrupting, so they raise here with the shapes spelled out.
    """
    mask = np.asarray(mask)
    if mask.dtype != np.bool_:
        raise TypeError(f"{what}: keep-mask must be boolean, got dtype "
                        f"{mask.dtype} (an integer mask would gather, "
                        "not select)")
    if mask.ndim != 1 or mask.shape[0] != dim:
        raise ValueError(f"{what}: keep-mask shape {mask.shape} does not "
                         f"match the channel dim ({dim})")
    if not mask.any():
        raise ValueError(f"{what}: keep-mask keeps zero channels")
    return mask


def _select(t: torch.Tensor, mask: np.ndarray, dim: int) -> torch.Tensor:
    """Keep the masked entries of ``dim``; the result is contiguous."""
    idx = torch.from_numpy(np.flatnonzero(mask)).to(t.device)
    return t.index_select(dim, idx)


def prune_conv_weights(w: torch.Tensor, keep_out: np.ndarray | None = None,
                       keep_in: np.ndarray | None = None) -> torch.Tensor:
    """Slice (FL, FL, IC, K) (or (IC, K)) weights down to kept channels.

    ``keep_out``/``keep_in`` are boolean keep-masks over the output (last)
    and input (second-to-last) channel dims; ``None`` keeps that dim whole.
    Masks are validated against the actual dims — a length or dtype mismatch
    raises instead of silently mis-slicing.
    """
    if w.ndim < 2:
        raise ValueError(f"conv weights must have >= 2 dims (got {tuple(w.shape)})")
    if keep_in is not None:
        keep_in = _validate_mask(keep_in, w.shape[-2], "keep_in")
        w = _select(w, keep_in, w.ndim - 2)
    if keep_out is not None:
        keep_out = _validate_mask(keep_out, w.shape[-1], "keep_out")
        w = _select(w, keep_out, w.ndim - 1)
    return w


def prune_bn(bn: dict, keep: np.ndarray) -> dict:
    """Prune per-channel epilogue operands (folded-BN scale/bias) to a mask.

    Keeps the fused dispatch consistent: a conv whose output channels were
    pruned must run with (K_kept,) scale/bias vectors, not the dense ones.
    """
    sizes = {v.shape[0] for v in bn.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent BN operand lengths: {sorted(sizes)}")
    keep = _validate_mask(keep, sizes.pop(), "bn")
    return {k: _select(v, keep, 0) for k, v in bn.items()}


def prune_plan(widths: list[int], keep_fractions: list[float],
               ic0: int) -> list[tuple[int, int]]:
    """Propagate channel pruning through a chain of conv layers.

    widths[i] = output channels of layer i; ``ic0`` = the chain's real input
    channel count (e.g. 3 for RGB).  Returns [(IC_i, K_i)] with actual
    channel counts after pruning, where layer i's IC is layer i-1's pruned K
    (the paper's Table I pattern) and layer 0's IC is ``ic0``.
    """
    if len(widths) != len(keep_fractions):
        raise ValueError(f"widths ({len(widths)}) and keep_fractions "
                         f"({len(keep_fractions)}) must align")
    out: list[tuple[int, int]] = []
    prev_k = ic0
    for w_i, f_i in zip(widths, keep_fractions):
        k = max(1, int(round(w_i * f_i)))
        out.append((prev_k, k))
        prev_k = k
    return out


@dataclass(frozen=True)
class SparsityTag:
    """Dense-twin channel counts of a pruned conv, for the measured ledger.

    A pruned dispatch passes this to ``carla_conv(sparsity=...)`` so its span
    records ``keep_fraction`` (kept MAC fraction) and ``dense_twin_macs``
    (the MACs the unpruned twin would have executed) next to the measured
    wall time and bytes — the sparse side of the paper's Table I, measured.
    """

    dense_ic: int
    dense_k: int

    def keep_fraction(self, ic: int, k: int) -> float:
        """Fraction of the dense twin's MACs the pruned layer keeps."""
        return (ic * k) / (self.dense_ic * self.dense_k)

    def dense_twin(self, layer: ConvLayer) -> ConvLayer:
        """The unpruned ConvLayer this pruned layer descends from."""
        return replace(layer, IC=self.dense_ic, K=self.dense_k)
