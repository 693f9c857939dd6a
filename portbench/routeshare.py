"""A kernel route's share of its roofline, for the routes that
``hostspans.ROUTES`` does not know: the depthwise conv (``dwconv``, its
launches inside ``carla_conv`` spans) and the squeeze-and-excitation gate
and the pass that applies it (``se`` and ``se_scale``, inside ``cnn.se``
spans).

Each device op of the profiled pass (``hostspans.passes``) is tied to the
``kernels.launch`` span whose call launched it, by the CUDA runtime's
record of that call, never by the kernel's name; the launch's ``route``
says whose it is, and the innermost enclosing span named ``owner`` its
layer (``layer``).  The layer's least time is that of the benchmark's own
ops of that name, or named ``<layer>.<part>`` (an SE gate's mean, two fcs
and the pass), counted once a layer however many of its kernels ran.  A forward that launches nothing on the route (a net with no
depthwise conv or SE gate) reads 0.0; a program without the route reads
None.
"""
from __future__ import annotations

import bisect

from . import hostspans
from .archs import work


def owned_launches(roots: list, anchor, owner: str) -> list[tuple]:
    """(start ns, end ns, kernels.launch span, its innermost ``owner`` span
    or None) of every launch, in order."""
    out = []

    def walk(sp, own):
        if sp.name == owner:
            own = sp
        if sp.name == "kernels.launch":
            start = anchor.epoch_ns(sp.start_s)
            out.append((start, start + round(sp.duration_s * 1e9), sp, own))
        for c in sp.children:
            walk(c, own)
    for root in roots:
        walk(root, None)
    return sorted(out, key=lambda t: t[0])


def layer_ops(ops_table: list, name: str | None) -> list:
    """The table's ops of layer ``name``: the op of that name, or its
    parts (``name.<part>``)."""
    if not name:
        return []
    return [o for o in ops_table
            if o.name == name or o.name.startswith(name + ".")]


def share(ops_table: list, peak: dict, device_ops: list, launches: list,
          routes: tuple) -> float | None:
    """The least time of the layers whose launches on ``routes`` ran the
    matched device ops, each layer once, over those ops' device time, in
    %; None where no op matched or a launch's layer is not in the table."""
    starts = [s for s, _, _, _ in launches]
    least = device = 0.0
    counted = set()
    for op in device_ops:
        if op.launched_ns is None:
            continue
        i = bisect.bisect_right(starts, op.launched_ns) - 1
        if i < 0 or op.launched_ns > launches[i][1]:
            continue
        _, _, launch, own = launches[i]
        if launch.attrs.get("route") not in routes:
            continue
        layer = layer_ops(ops_table, own.attrs.get("layer") if own else None)
        if not layer:
            return None
        if id(own) not in counted:
            counted.add(id(own))
            least += work.least_seconds(layer, peak["flops_per_s"],
                                        peak["bytes_per_s"])
        device += (op.end_ns - op.start_ns) / 1e9
    return 100.0 * least / device if device > 0 else None


def has_route(route: str) -> bool:
    """Whether the program launches kernels on ``route`` (a key of its
    ``kernels/_build.ROUTES``), where an older program has no such route."""
    from repro_torch.kernels import _build
    return route in getattr(_build, "ROUTES", {})


def roofline(r, routes: tuple, owner: str) -> float | None:
    """``share`` of a ``--trace 1`` run's reading: 0.0 where the profiled
    pass launched nothing on ``routes``; None without the routes in the
    program, its anchored spans, a device trace or the card's peaks."""
    if not all(has_route(x) for x in routes):
        return None
    p = hostspans.passes(r)
    if p is None or r.peak is None:
        return None
    launches = owned_launches(p.profiled, p.anchor, owner)
    if not any(l[2].attrs.get("route") in routes for l in launches):
        return 0.0
    return share(r.ops, r.peak, p.ops, launches, routes)
