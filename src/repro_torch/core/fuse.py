"""Fused conv epilogues — BN folding + the ``Epilogue`` descriptor.

CARLA's whole argument is that off-chip feature-map traffic dominates energy,
yet a naive CNN forward materializes every conv output to device memory and
then reads it back for batch-norm, again for the activation, and once more for
the residual add.  The CUDA kernels apply those element-wise steps at the
*flush*, directly on the fp32 accumulator in registers, so the feature map
crosses the device-memory boundary exactly once.

``Epilogue`` describes what the flush applies, in this fixed order (matching
the ResNet bottleneck: ``relu(bn(conv(x)) + shortcut)``):

    y = acc * scale + bias        # inference-folded BN (or plain conv bias)
    y = y + residual              # shortcut add
    y = max(y, 0)                 # ReLU

or, with ``silu`` (EfficientNet's blocks, whose shortcut is added after the
activation: ``silu(bn(conv(x))) + shortcut``):

    y = acc * scale + bias
    y = y * sigmoid(y)            # SiLU
    y = y + residual

One more thing rides the same dispatch: ``sums``, an output the depthwise
conv's flush writes besides the map: fp32 ``(B, tiles, C)``, each tile's sum of the
flushed values by channel (``kernels.dwconv``), what the block's SE mean
reads.

``fold_bn`` turns training-time BN statistics into that (scale, bias) pair;
``fold_bn_into_conv`` goes one step further and bakes the scale into the conv
weights so the epilogue degenerates to a bias add.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Epilogue:
    """What the kernel applies to the fp32 accumulator before writeback.

    scale/bias: per-output-channel ``(K,)`` vectors (inference-folded BN);
    residual:   a tensor of the conv's output shape, added before the ReLU
                (after the SiLU);
    relu:       apply ``max(y, 0)`` last;
    silu:       apply ``y * sigmoid(y)`` after scale and bias, before the
                residual (not with ``relu``);
    sums:       fp32 ``(B, tiles, C)``, written: each pixel tile's sum of
                the flushed values (the depthwise conv's).
    """

    scale: torch.Tensor | None = None
    bias: torch.Tensor | None = None
    relu: bool = False
    residual: torch.Tensor | None = None
    silu: bool = False
    sums: torch.Tensor | None = None

    def __post_init__(self):
        if self.relu and self.silu:
            raise ValueError("an epilogue applies ReLU or SiLU, not both")

    @property
    def is_noop(self) -> bool:
        return (self.scale is None and self.bias is None
                and not self.relu and self.residual is None
                and not self.silu and self.sums is None)

    @property
    def tag(self) -> str:
        """Span-attribute label, e.g. ``"scale+bias+relu"`` or ``"none"``;
        in the order applied."""
        parts = [n for n, on in (("scale", self.scale is not None),
                                 ("bias", self.bias is not None),
                                 ("silu", self.silu),
                                 ("residual", self.residual is not None),
                                 ("relu", self.relu),
                                 ("sums", self.sums is not None)) if on]
        return "+".join(parts) if parts else "none"

    @property
    def n_fused_ops(self) -> int:
        """Element-wise passes over the output fmap that fusion eliminates.

        scale/bias count as one pass (one fused-multiply-add sweep), the
        residual add as one, the ReLU as one — each would otherwise read the
        full output from device memory and write it back.
        """
        return (int(self.scale is not None or self.bias is not None)
                + int(self.residual is not None) + int(self.relu)
                + int(self.silu))


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor,
            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BN statistics into an inference (scale, bias) pair.

    ``bn(y) = scale * (y - mean) / sqrt(var + eps) + bias`` becomes
    ``y * eff_scale + eff_bias`` — exactly the epilogue's first step.
    """
    inv = scale.float() / torch.sqrt(var.float() + eps)
    return inv, bias.float() - mean.float() * inv


def fold_bn_into_conv(w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor,
                      eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Bake BN's multiplicative term into conv weights.

    w: ``(FH, FW, C, K)`` (or ``(C, K)`` for a 1x1); returns ``(w', bias')``
    with ``conv(x, w') + bias' == bn(conv(x, w))`` — the epilogue then needs
    only the bias add.
    """
    eff_scale, eff_bias = fold_bn(scale, bias, mean, var, eps)
    return w * eff_scale.to(w.dtype), eff_bias


def apply_epilogue(y: torch.Tensor, epilogue: Epilogue | None) -> torch.Tensor:
    """Reference (unfused) application of an epilogue, in fp32.

    The oracle the fused kernels are tested against; also usable to run any
    model's unfused twin for parity checks.  The sums are written by the
    conv, so they are not applied here.
    """
    if epilogue is None or epilogue.is_noop:
        return y
    dtype = y.dtype
    y = y.float()
    if epilogue.scale is not None:
        y = y * epilogue.scale.float()
    if epilogue.bias is not None:
        y = y + epilogue.bias.float()
    if epilogue.silu:
        y = torch.nn.functional.silu(y)
    if epilogue.residual is not None:
        y = y + epilogue.residual.float()
    if epilogue.relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(dtype)
