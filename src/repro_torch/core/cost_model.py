"""CARLA analytic performance model — paper Eqs (2)-(12), exactly.

Every quantity is a deterministic function of the layer shape and the
architecture constants (U=64 CUs, 196 PEs, 224-word SRAM pairs, 200 MHz,
16-bit words).  This module reproduces the paper's headline numbers:

    ResNet-50:        92.8 ms  (paper:  92.7),  123.6 MB DRAM (paper: 124.0)
    VGG-16:          393.0 ms  (paper: 396.9),  258.8 MB DRAM (paper: 258.2)
    sparse ResNet-50: 42.5 ms  (paper:  42.5),  ~63 MB        (paper:  63.3)
    PUF: 98.46% (3x3, 1x1), 87.1%/95.0% (Conv5 small-fmap), 45.0% (Conv1)

Known paper errata handled here (see DESIGN.md §1.1):
  * Eq (10) as printed is inconsistent with Fig 8; the corrected small-fmap
    cycle count OL^2 * IC * ceil(K / #PEs) reproduces Fig 8.  The printed form
    is kept as ``eq10_as_printed`` for reference.
  * Eq (4)'s Q = 3*IC (three weights fetched per (filter-row, channel) step).
  * The Conv1 7x7 decomposition cycle model (not in closed form in the paper):
    14 three-tap row pieces stream OL*IL inputs, 7 one-tap pieces stream OL^2.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .modes import (
    FREQ_HZ,
    NUM_PES,
    SRAM_WORDS,
    U,
    WORD_BYTES,
    ConvLayer,
    Dataflow,
    select_dataflow,
)
from .networks import resnet50_conv_layers, vgg16_conv_layers


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class LayerCost:
    layer: ConvLayer
    dataflow: Dataflow
    cycles: int
    dram_in: int        # input-feature fetches (words)
    dram_weights: int   # filter-weight fetches (words)
    dram_out: int       # output-feature stores (words)
    macs: int           # useful MACs, Eq (6)

    @property
    def dram_total(self) -> int:
        return self.dram_in + self.dram_weights + self.dram_out

    @property
    def dram_bytes(self) -> int:
        return self.dram_total * WORD_BYTES

    @property
    def time_s(self) -> float:
        return self.cycles / FREQ_HZ

    @property
    def puf(self) -> float:
        """Exact PE Utilization Factor, Eq (5)."""
        return self.macs / (NUM_PES * self.cycles)


def partitions_3x3(layer: ConvLayer) -> int:
    """P for the 3x3 mode: sub-out-fmaps sized by the 224-word SRAM pair."""
    rows_per_part = max(1, SRAM_WORDS // layer.OL)
    return _ceil_div(layer.OL, rows_per_part)


def partitions_1x1(layer: ConvLayer) -> int:
    """P for the 1x1 feature-stationary mode: 196 features per sub-out-fmap."""
    return _ceil_div(layer.OL * layer.OL, NUM_PES)


def puf_closed_form(layer: ConvLayer) -> float:
    """The paper's simplified PUF expressions (§III.A.2 / §III.B.2)."""
    df = select_dataflow(layer)
    if df == Dataflow.CONV3X3_SERIAL_ACC:
        return layer.K / ((U + 1) * _ceil_div(layer.K, U))
    if df == Dataflow.CONV1X1_FEATURE_STATIONARY:
        return U / (U + 1)
    # weight-stationary / 7x7: the paper reports measured values; use exact.
    return layer_cost(layer).puf


def eq10_as_printed(layer: ConvLayer) -> int:
    """Eq (10) exactly as printed (inconsistent with Fig 8; kept for reference)."""
    return U * layer.IC * _ceil_div(layer.K, 3 * U)


def layer_cost(layer: ConvLayer) -> LayerCost:
    """Cycles + DRAM accesses for one layer under the paper's selected mode."""
    df = select_dataflow(layer)
    OL, IL, IC, K, Z = layer.OL, layer.IL, layer.IC, layer.K, layer.Z
    kg = _ceil_div(K, U)  # filter groups of U

    if df == Dataflow.CONV3X3_SERIAL_ACC:
        P = partitions_3x3(layer)
        cycles = (3 * OL * OL - 2 * Z * OL) * IC * kg                 # Eq (2)
        dram_in = (IL + 2 * P - 2 * Z) * IL * IC * kg                 # Eq (3)
        q = 3 * IC                                                    # steps/sub-out-fmap
        dram_w = 3 * U * q * kg * P                                   # Eq (4)
        dram_out = OL * OL * K

    elif df == Dataflow.CONV1X1_FEATURE_STATIONARY:
        P = partitions_1x1(layer)
        cycles = (U + 1) * IC * P * kg                                # Eq (7)
        dram_w = U * IC * P * kg                                      # Eq (8)
        dram_in = OL * OL * IC * kg                                   # Eq (9)
        dram_out = OL * OL * K

    elif df == Dataflow.CONV1X1_WEIGHT_STATIONARY:
        kp = _ceil_div(K, NUM_PES)
        cycles = OL * OL * IC * kp            # corrected Eq (10), see DESIGN.md
        dram_w = K * layer.FL**2 * IC                                 # Eq (11)
        dram_in = IL * IL * IC * kp                                   # Eq (12)
        dram_out = OL * OL * K

    elif df == Dataflow.CONV7X7_ROW_DECOMPOSED:
        # 21 pieces: 14 three-tap rows (stride-2 rows touch every input column
        # -> OL*IL streamed) + 7 one-tap rows (even columns only -> OL*OL).
        cycles = (14 * OL * IL + 7 * OL * OL) * IC * kg
        P = _ceil_div(OL * OL, SRAM_WORDS)
        dram_in = (IL + 2 * P - 2 * Z) * IL * IC * kg                 # Eq (3) pattern
        # Eq (4) pattern with Q = 21*IC piece-steps per sub-out-fmap (vs 3*IC
        # row-steps in the 3x3 mode): 3 weight slots fetched per step, per CU.
        q = 21 * IC
        dram_w = 3 * U * q * kg * P                                   # Eq (4) pattern
        dram_out = OL * OL * K
    else:  # pragma: no cover
        raise ValueError(df)

    return LayerCost(layer, df, int(cycles), int(dram_in), int(dram_w),
                     int(dram_out), layer.macs)


def epilogue_dram_delta(layer: ConvLayer, *, scale_bias: bool = False,
                        relu: bool = False, residual: bool = False) -> int:
    """Extra DRAM words an UNfused epilogue costs over the fused flush.

    Each element-wise pass (folded-BN scale/bias, residual add, ReLU) over an
    unfused conv output reads the full OLxOLxK feature map from DRAM and
    writes it back; fusing it into the kernel's flush removes both transfers.
    The residual *operand* is read once either way, so it does not appear in
    the delta.  Returned in 16-bit words (the paper's unit); multiply by
    ``WORD_BYTES`` for bytes.
    """
    n_ops = int(scale_bias) + int(relu) + int(residual)
    return 2 * n_ops * layer.OL * layer.OL * layer.K


def epilogue_dram_delta_bytes(layer: ConvLayer, **ops) -> int:
    return epilogue_dram_delta(layer, **ops) * WORD_BYTES


@dataclass(frozen=True)
class NetworkCost:
    name: str
    layers: tuple[LayerCost, ...]

    @property
    def cycles(self) -> int:
        return sum(lc.cycles for lc in self.layers)

    @property
    def time_ms(self) -> float:
        return self.cycles / FREQ_HZ * 1e3

    @property
    def dram_mb(self) -> float:
        """DRAM traffic in MB (10^6 bytes, 16-bit words) -- paper convention."""
        return sum(lc.dram_bytes for lc in self.layers) / 1e6

    @property
    def macs(self) -> int:
        return sum(lc.macs for lc in self.layers)

    @property
    def gops(self) -> float:
        """Throughput in Gops (2 ops per MAC), paper Table II convention."""
        return 2 * self.macs / (self.cycles / FREQ_HZ) / 1e9

    @property
    def puf(self) -> float:
        return self.macs / (NUM_PES * self.cycles)


def network_cost(name: str, layers: list[ConvLayer]) -> NetworkCost:
    return NetworkCost(name, tuple(layer_cost(l) for l in layers))


def resnet50_cost(sparse: bool = False) -> NetworkCost:
    tag = "resnet50_sparse" if sparse else "resnet50"
    return network_cost(tag, resnet50_conv_layers(sparse=sparse))


def vgg16_cost() -> NetworkCost:
    return network_cost("vgg16", vgg16_conv_layers())
