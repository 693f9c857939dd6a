"""Elastic scaling: the plan for recovering onto a degraded (or grown)
mesh (port of ``repro.runtime.elastic``).

Power-of-two shrink: the largest (data, model) mesh with data' <= data a
power of two and model unchanged (a lost model-parallel group kills its
slice anyway, so elasticity works on the data axis); the global batch is
kept by raising per-replica microbatching.  ``build_mesh`` makes the
plan's mesh over the caller's process group.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..observability import events


def largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


@dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    grad_accum_factor: int   # microbatch multiplier to preserve global batch


def plan_remesh(old_shape: tuple, axis_names: tuple,
                devices_available: int) -> ElasticPlan:
    """Shrink the data axis to fit ``devices_available`` devices."""
    model = old_shape[-1]
    lead = old_shape[:-2]            # ('pod',) or ()
    lead_n = 1
    for d in lead:
        lead_n *= d
    if devices_available < model:
        raise ValueError("cannot preserve model-parallel groups: "
                         f"{devices_available} devices < model {model}")
    new_data = largest_pow2_leq(devices_available // (model * lead_n))
    old_data = old_shape[-2]
    accum = max(1, old_data // new_data)
    plan = ElasticPlan(old_shape, lead + (new_data, model), axis_names, accum)
    if events.enabled():
        events.emit("elastic.remesh", old_shape=list(old_shape),
                    new_shape=list(plan.new_shape),
                    devices_available=devices_available,
                    grad_accum_factor=accum)
    return plan


def build_mesh(plan: ElasticPlan, *, device_type: str = "cuda"):
    """The device mesh of ``plan.new_shape`` named ``plan.axis_names``."""
    from ..launch.mesh import make_mesh
    return make_mesh(plan.new_shape, plan.axis_names,
                     device_type=device_type)
