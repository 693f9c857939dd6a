"""Planned-vs-measured reconciliation — the repo's answer to paper Table II.

The analytic side of each row comes from ``core.cost_model.LayerCost``
(cycles at 200 MHz, DRAM words, PUF); the measured side comes from the
telemetry spans that ``core.carla.carla_conv`` records: the host's time
of the dispatch from its call to its return (plan, operand checks and
launch: no span waits for the device, so on the card a traced span is
not the kernel's time; ``bench.telemetry_report`` puts the device's
cold-L2 time in its place), tensor bytes actually touched, achieved
FLOP/s.  A copy of ``repro.observability.report``
over the port's spans, which carry the same attributes.

Utilization is reported on both sides in its own native denominator:

  * analytic **PUF** — useful MACs / (196 PEs x cycles), the paper's Eq (5);
  * measured **util%** — achieved dense FLOP/s as a fraction of ``peak_gflops``
    (pass the backend's peak; defaults to the best layer observed in the run,
    i.e. utilization relative to the machine's demonstrated ceiling).

Both measure the same thing — how much of the available MAC capacity the
chosen dataflow keeps busy — so a layer whose analytic PUF is high but whose
measured util% is low is a real finding (the mode the controller picked does
not map well onto the execution backend), exactly the kind of discrepancy
this layer exists to surface.
"""
from __future__ import annotations

from dataclasses import dataclass

from .trace import Span

CARLA_SPAN = "carla_conv"


@dataclass(frozen=True)
class ReconRow:
    layer: str
    dataflow: str
    # analytic (per inference, batch-1, from LayerCost); None for a layer
    # the ASIC model cannot cost (a depthwise conv)
    analytic_cycles: int | None
    analytic_ms: float | None
    analytic_dram_mb: float | None
    analytic_puf: float | None
    # measured (per dispatch, whatever batch the span ran)
    batch: int
    measured_ms: float
    measured_bytes_mb: float
    achieved_gflops: float
    measured_util: float        # achieved / peak_gflops
    # fused epilogue (``none`` when the dispatch ran without one)
    epilogue: str = "none"
    fused_saved_mb: float = 0.0  # HBM round-trips the fused flush removed
    # empirical tuning ledger: was a tuned plan applied, what ran, where it
    # came from, and the padding-waste PUF analogue
    tuned: bool = False
    tile_config: str = "default"
    tuning_source: str = "analytic"
    tile_util: float = 1.0       # logical FLOPs / padded FLOPs
    # structured-sparsity ledger: was the layer channel-pruned, what MAC
    # fraction it kept vs its dense twin
    pruned: bool = False
    macs: int = 0
    keep_fraction: float = 1.0
    dense_twin_macs: int = 0

    @property
    def speed_ratio(self) -> float:
        """Measured wall time over analytic ASIC time, batch-normalized."""
        if not self.analytic_ms or self.analytic_ms <= 0:
            return float("inf")
        return (self.measured_ms / max(1, self.batch)) / self.analytic_ms


def _carla_spans(spans: list[Span]) -> list[Span]:
    return [s for root in spans for s in root.walk() if s.name == CARLA_SPAN]


def reconcile(spans: list[Span],
              peak_gflops: float | None = None) -> list[ReconRow]:
    """Build per-layer reconciliation rows from a recorded span forest."""
    carla = _carla_spans(spans)
    rows: list[ReconRow] = []
    achieved = []
    for s in carla:
        a = s.attrs
        batch = int(a.get("batch", 1))
        # dense FLOPs are what the backend executes (pad MACs included)
        gflops = (2.0 * a["dense_macs"] * batch / s.duration_s / 1e9
                  if s.duration_s > 0 else 0.0)
        achieved.append(gflops)
        rows.append((s, batch, gflops))
    peak = peak_gflops or (max(achieved) if achieved else 1.0)
    out = []
    for s, batch, gflops in rows:
        a = s.attrs
        costed = a["analytic_cycles"] is not None
        out.append(ReconRow(
            layer=a["layer"],
            dataflow=a["dataflow"],
            analytic_cycles=int(a["analytic_cycles"]) if costed else None,
            analytic_ms=a["analytic_time_ms"],
            analytic_dram_mb=(a["analytic_dram_bytes"] / 1e6 if costed
                              else None),
            analytic_puf=a["analytic_puf"],
            batch=batch,
            measured_ms=s.duration_s * 1e3,
            measured_bytes_mb=a.get("bytes_touched", 0) / 1e6,
            achieved_gflops=gflops,
            measured_util=gflops / peak if peak else 0.0,
            epilogue=a.get("epilogue", "none"),
            fused_saved_mb=a.get("epilogue_hbm_saved", 0) / 1e6,
            tuned=bool(a.get("tuned", False)),
            tile_config=a.get("tile_config", "default"),
            tuning_source=a.get("tuning_source", "analytic"),
            tile_util=float(a.get("tile_util", 1.0)),
            pruned=bool(a.get("pruned", False)),
            macs=int(a.get("macs", 0)),
            keep_fraction=float(a.get("keep_fraction", 1.0)),
            dense_twin_macs=int(a.get("dense_twin_macs", a.get("macs", 0))),
        ))
    return out


def totals(rows: list[ReconRow]) -> dict:
    """Network-level sums (the Table II bottom line); the analytic sums
    and ``speed_ratio`` over the layers the ASIC model costs."""
    if not rows:
        return {}
    costed = [r for r in rows if r.analytic_ms is not None]
    an_ms = sum(r.analytic_ms for r in costed)
    me_ms = sum(r.measured_ms / max(1, r.batch) for r in rows)
    twin_macs = sum(r.dense_twin_macs for r in rows)
    return {
        "layers": len(rows),
        "analytic_ms": an_ms,
        "analytic_dram_mb": sum(r.analytic_dram_mb for r in costed),
        "measured_ms_per_image": me_ms,
        "measured_bytes_mb": sum(r.measured_bytes_mb for r in rows),
        "fused_saved_mb": sum(r.fused_saved_mb for r in rows),
        "speed_ratio": (sum(r.measured_ms / max(1, r.batch) for r in costed)
                        / an_ms if an_ms else float("inf")),
        "pruned_layers": sum(1 for r in rows if r.pruned),
        # kept MAC fraction over the whole net vs the dense twins (1.0 dense)
        "mac_keep_fraction": (sum(r.macs for r in rows) / twin_macs
                              if twin_macs else 1.0),
    }


def format_table(rows: list[ReconRow]) -> str:
    """Fixed-width text table: analytic columns left, measured columns right."""
    headers = ["layer", "dataflow", "cycles", "an.ms", "an.MB", "PUF%",
               "B", "ms", "MB", "GFLOP/s", "util%", "x-ASIC",
               "epilogue", "savedMB", "tile%", "tiles", "keep%"]
    cells = [[
        r.layer, r.dataflow.replace("_", "-"),
        *((f"{r.analytic_cycles:,}", f"{r.analytic_ms:7.3f}",
           f"{r.analytic_dram_mb:6.2f}", f"{r.analytic_puf * 100:5.1f}")
          if r.analytic_cycles is not None else ("-",) * 4),
        str(r.batch), f"{r.measured_ms:8.2f}", f"{r.measured_bytes_mb:6.2f}",
        f"{r.achieved_gflops:7.2f}", f"{r.measured_util * 100:5.1f}",
        f"{r.speed_ratio:6.2f}", r.epilogue, f"{r.fused_saved_mb:6.2f}",
        f"{r.tile_util * 100:5.1f}",
        r.tile_config if r.tuned else "default",
        f"{r.keep_fraction * 100:5.1f}" if r.pruned else "dense",
    ] for r in rows]
    widths = [max(len(h), *(len(c[i]) for c in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.rjust(w) for h, w in zip(headers, widths))]
    lines.append("-" * len(lines[0]))
    lines += ["  ".join(c.rjust(w) for c, w in zip(row, widths))
              for row in cells]
    return "\n".join(lines)
