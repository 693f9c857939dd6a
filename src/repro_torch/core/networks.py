"""Layer tables for the paper's benchmark CNNs.

ResNet-50 follows the *original* He et al. variant the paper uses: the stride-2
convolution of each transition block is the FIRST 1x1 of the block (this is what
makes the paper's statement that layers #11/#23/#41 take half the time of the
group-opening layers come out exactly).  The 49 layers counted by the paper
exclude the 4 projection (downsample) shortcuts; we keep those in a separate
list for completeness.

The structured-sparse ResNet-50 (Table I, 50% channel pruning) halves the
filter counts of the first two convs of every bottleneck; the block-output 1x1
keeps its filter count.  Input-channel counts follow from the previous layer's
(pruned) outputs -- the residual trunk stays unpruned, so the first 1x1 of each
block still sees the full trunk width.
"""
from __future__ import annotations

from .modes import ConvLayer


def resnet50_conv_layers(sparse: bool = False) -> list[ConvLayer]:
    """The 49 convolutional layers of ResNet-50 in execution order."""
    h = 0.5 if sparse else 1.0  # pruning factor on the first two convs per block

    layers: list[ConvLayer] = [
        ConvLayer("conv1", IL=224, IC=3, K=64, FL=7, S=2, Z=3),
    ]

    # (group, n_blocks, trunk_in, mid, out, IL_in)
    groups = [
        ("conv2", 3, 64, 64, 256, 56),     # after 3x3/2 maxpool: 56x56x64
        ("conv3", 4, 256, 128, 512, 56),   # first block strides 56 -> 28
        ("conv4", 6, 512, 256, 1024, 28),
        ("conv5", 3, 1024, 512, 2048, 14),
    ]
    for gname, n_blocks, trunk_in, mid, out, il_in in groups:
        midp = int(mid * h)
        for b in range(n_blocks):
            stride = 2 if (b == 0 and gname != "conv2") else 1
            il = il_in if b == 0 else (il_in // 2 if gname != "conv2" else il_in)
            ic0 = trunk_in if b == 0 else out
            ol = il // stride
            layers += [
                # 1x1 reduce (carries the stride in the original variant)
                ConvLayer(f"{gname}_b{b}_1x1a", IL=il, IC=ic0, K=midp, FL=1, S=stride),
                # 3x3
                ConvLayer(f"{gname}_b{b}_3x3", IL=ol, IC=midp, K=midp, FL=3, S=1, Z=1),
                # 1x1 expand (unpruned per Table I)
                ConvLayer(f"{gname}_b{b}_1x1b", IL=ol, IC=midp, K=out, FL=1, S=1),
            ]
    assert len(layers) == 49
    return layers


def resnet50_projection_shortcuts(sparse: bool = False) -> list[ConvLayer]:
    """The 4 downsample 1x1 convs (not in the paper's 49-layer count)."""
    del sparse  # trunk is unpruned
    return [
        ConvLayer("conv2_proj", IL=56, IC=64, K=256, FL=1, S=1),
        ConvLayer("conv3_proj", IL=56, IC=256, K=512, FL=1, S=2),
        ConvLayer("conv4_proj", IL=28, IC=512, K=1024, FL=1, S=2),
        ConvLayer("conv5_proj", IL=14, IC=1024, K=2048, FL=1, S=2),
    ]


def vgg16_conv_layers() -> list[ConvLayer]:
    """The 13 convolutional layers of VGG-16 (all 3x3, S=1, Z=1)."""
    spec = [
        (224, 3, 64), (224, 64, 64),
        (112, 64, 128), (112, 128, 128),
        (56, 128, 256), (56, 256, 256), (56, 256, 256),
        (28, 256, 512), (28, 512, 512), (28, 512, 512),
        (14, 512, 512), (14, 512, 512), (14, 512, 512),
    ]
    return [
        ConvLayer(f"vgg_L{i+1}_{k}-{ic}-{il}", IL=il, IC=ic, K=k, FL=3, S=1, Z=1)
        for i, (il, ic, k) in enumerate(spec)
    ]


def smoke_conv_layers(sparse: bool = False) -> list[ConvLayer]:
    """Tiny layers covering every dataflow the controller can pick.

    Shapes are chosen so the whole set compiles and runs in seconds on CPU;
    benchmark CLIs use this for their ``--smoke`` mode (CI liveness, not
    performance claims).

    ``sparse=True`` returns the structured-pruned twins (same names, same
    dataflow assignment, channels halved following the Table I pattern:
    out-pruned 3x3/7x7, in-pruned 1x1s) so the sparse bench/gate path has a
    CI-sized layer set whose every layer touches fewer bytes than its twin.
    """
    if sparse:
        return [
            ConvLayer("smoke_3x3", IL=14, IC=4, K=8, FL=3, S=1, Z=1),
            ConvLayer("smoke_1x1_fs", IL=28, IC=8, K=8, FL=1),
            ConvLayer("smoke_1x1_ws", IL=7, IC=8, K=8, FL=1),
            ConvLayer("smoke_7x7", IL=28, IC=3, K=4, FL=7, S=2, Z=3),
        ]
    return [
        ConvLayer("smoke_3x3", IL=14, IC=8, K=16, FL=3, S=1, Z=1),
        ConvLayer("smoke_1x1_fs", IL=28, IC=16, K=8, FL=1),
        ConvLayer("smoke_1x1_ws", IL=7, IC=16, K=8, FL=1),
        ConvLayer("smoke_7x7", IL=28, IC=3, K=8, FL=7, S=2, Z=3),
    ]


# Layer tables that have a structured-sparse twin (same layer names, pruned
# channel counts) — the benchmark CLIs' ``--sparse`` universe.
SPARSE_NETS = ("resnet50", "smoke")


def sparse_conv_layers(net: str) -> list[ConvLayer]:
    """The structured-sparse twin of a net's layer table.

    Layer names match the dense table exactly, so dense/sparse records pair
    by name (the ``sparse_delta`` section of the bench record).
    """
    if net == "resnet50":
        return resnet50_conv_layers(sparse=True)
    if net == "smoke":
        return smoke_conv_layers(sparse=True)
    raise KeyError(f"no structured-sparse layer table for {net!r} "
                   f"(have {list(SPARSE_NETS)})")
