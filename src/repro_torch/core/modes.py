"""CARLA operating modes and the dataflow planner.

The paper's controller selects one of four dataflows per layer based on the
layer's shape (filter size, spatial size vs. PE count).  This module is the
software twin of that controller: it reproduces the paper's selection rule
exactly for the ASIC model (used by ``core.cost_model``) and generalizes the
same decision quantities to GPU tiling (used by ``kernels.ops`` to pick the
stationarity of the CUDA GEMM kernels).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

# --- ASIC-side architecture constants (paper §III, ResNet configuration) ----
U = 64                  # convolution units CU#0..CU#63 (CU#64 is the extra one)
N_PE_PER_CU = 3         # PEs per CU (CU#U has 4)
NUM_PES = U * N_PE_PER_CU + 4      # = 196
SRAM_WORDS = 224        # words per CU SRAM pair (divisible by all ResNet rows)
FREQ_HZ = 200e6         # 200 MHz
WORD_BYTES = 2          # 16-bit weights/features


class Dataflow(enum.Enum):
    """The paper's four operating modes (§III.A-D)."""

    CONV3X3_SERIAL_ACC = "3x3_serial_accumulation"   # §III.A  output-stationary
    CONV1X1_FEATURE_STATIONARY = "1x1_feature_stationary"  # §III.B  weights stream
    CONV1X1_WEIGHT_STATIONARY = "1x1_weight_stationary"    # §III.C  features stream
    CONV7X7_ROW_DECOMPOSED = "7x7_row_decomposition"       # §III.D  21 row pieces
    # Not one of the paper's: a depthwise conv (one filter a channel, as
    # EfficientNet's MBConv blocks run it).  The paper's controller and its
    # ASIC cost model have no depthwise case, so ``select_dataflow`` never
    # returns it and such a layer carries no analytic cost.
    DEPTHWISE = "depthwise"


@dataclass(frozen=True)
class ConvLayer:
    """One convolutional layer, in the paper's notation.

    IL: input spatial length (square fmaps), IC: input channels,
    K: number of filters (= OC), FL: filter length, S: stride, Z: zero pad.
    """

    name: str
    IL: int
    IC: int
    K: int
    FL: int
    S: int = 1
    Z: int = 0

    @property
    def OL(self) -> int:
        return (self.IL - self.FL + 2 * self.Z) // self.S + 1

    @property
    def macs(self) -> int:
        """Useful MAC count, paper Eq (6) (pad MACs excluded)."""
        OL, FL, Z = self.OL, self.FL, self.Z
        return self.IC * self.K * (FL**2 * OL**2 - 2 * Z * (2 * FL * OL - 2 * Z))

    @property
    def dense_macs(self) -> int:
        """Plain MAC count including pad positions (FL² per output)."""
        return self.IC * self.K * self.FL**2 * self.OL**2


def select_dataflow(layer: ConvLayer, num_pes: int = NUM_PES) -> Dataflow:
    """The paper's mode-selection rule.

    - FL==3 -> serial accumulation (§III.A)
    - FL==1 -> feature-stationary (§III.B) unless the per-channel feature count
      is radically smaller than the PE count, in which case weights become the
      resident operand (§III.C).  The paper's criterion is 'number of features
      in a channel close to or greater than the number of PEs'.
    - FL>=5 -> row decomposition into <=3-tap pieces on the 3x3 machinery.
    """
    if layer.FL == 3:
        return Dataflow.CONV3X3_SERIAL_ACC
    if layer.FL == 1:
        if layer.OL * layer.OL < num_pes:
            return Dataflow.CONV1X1_WEIGHT_STATIONARY
        return Dataflow.CONV1X1_FEATURE_STATIONARY
    return Dataflow.CONV7X7_ROW_DECOMPOSED


# --- Accelerator-side generalization -----------------------------------------
class Stationarity(enum.Enum):
    """Which GEMM operand stays resident while the other streams.

    The kernel-level analogue of the paper's 1x1-mode operand swap: activations resident
    (weights stream) when there are at least a tile's worth of rows; weights
    resident (activations stream) when rows are scarce (decode: 1 token).
    """

    ACTIVATION_STATIONARY = "activation_stationary"   # paper §III.B analogue
    WEIGHT_STATIONARY = "weight_stationary"           # paper §III.C analogue


def select_stationarity(rows: int, tile_rows: int = 128) -> Stationarity:
    """rows = tokens (GEMM M dim); mirrors select_dataflow's feature-count rule."""
    if rows < tile_rows:
        return Stationarity.WEIGHT_STATIONARY
    return Stationarity.ACTIVATION_STATIONARY
