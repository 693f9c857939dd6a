"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device or process group.  Every mesh is a ``torch.distributed`` device mesh
over the caller's process group (``torchrun``'s, the tests' ``gloo`` group,
or the dry run's fake group), on ``"cuda"`` unless the caller asks for
another device type; nothing falls back to a CPU mesh when there is no
card.
"""
from __future__ import annotations

import os

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models import sharding_hints


def set_mesh(mesh):
    """Context manager making ``mesh`` the ambient mesh for the block (the
    one ``models.sharding_hints`` reads)."""
    return sharding_hints.use_mesh(mesh)


def make_mesh(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must be the product of ``shape``."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 devices per pod; 2x16x16 = 512 across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_smoke_mesh(*, device_type: str = "cuda"):
    """Degenerate 1x1 mesh: the sharded steps on one device."""
    return make_mesh((1, 1), ("data", "model"), device_type=device_type)


def mesh_from_flag(name: str, *, device_type: str = "cuda"):
    """The launchers' ``--mesh``: ``smoke`` is (1, 1) in this process (a
    one-process group made here when there is none); ``single`` and
    ``multi`` are the production meshes, which need ``torchrun`` with a
    world size of 256 or 512."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    if name == "smoke":
        if not dist.is_initialized():
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        return make_smoke_mesh(device_type=device_type)
    if name not in ("single", "multi"):
        raise ValueError(f"--mesh {name!r}: smoke, single or multi")
    want = 512 if name == "multi" else 256
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != want:
        raise SystemExit(f"--mesh {name} needs {want} processes (torchrun "
                         f"--nproc-per-node ... with a world size of {want});"
                         f" this run has a world size of {world}")
    if not dist.is_initialized():
        dist.init_process_group(backend)
    return make_production_mesh(multi_pod=name == "multi",
                                device_type=device_type)


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over (pod outermost when present)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def mesh_num_devices(mesh) -> int:
    return mesh.size()
