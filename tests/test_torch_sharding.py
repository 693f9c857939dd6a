"""The port's sharding rules (``repro_torch.launch.sharding``,
``optim.state_pspec``) against ``repro``'s, leaf by leaf: the same spec for
every param of all ten archs on both production meshes, every sharded axis
dividing its dim, the KV-cache rules with the batch divisible and at B 1,
and the optimizer states' specs of all four optimizers.  Specs are compared
as tuples (``tuple(PartitionSpec)``); no process group is needed."""
import types

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.launch import sharding as j_sharding
from repro.launch import steps as j_steps
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import state_pspec as j_state_pspec
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding, steps
from repro_torch.models import sharding_hints
from repro_torch.optim import state_pspec

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _repro_specs(tree):
    """{path: spec tuple} of a repro spec tree (dict keys joined by '/')."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree, path=()):
    """{path: spec} of a port spec tree (dicts and NamedTuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_port_specs(v, path + (f,)))
        return out
    return {"/".join(path): tree}


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (str(k),)))
        return out
    return {"/".join(path): tuple(tree.shape)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_repro(arch, mesh_name):
    sizes = MESHES[mesh_name]
    want = _repro_specs(j_sharding.make_param_pspecs(
        j_steps.param_specs(j_get_config(arch)), sizes))
    got = _port_specs(sharding.make_param_pspecs(
        steps.param_specs(get_config(arch)), sizes))
    assert got.keys() == want.keys()
    for path, spec in want.items():
        assert got[path] == spec, (path, got[path], spec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divide_dims(arch, mesh_name):
    """Every sharded axis divides its dim on the production mesh (full
    config), the counterpart of ``repro``'s test of the same name."""
    sizes = MESHES[mesh_name]
    structs = steps.param_specs(get_config(arch))
    specs = _port_specs(sharding.make_param_pspecs(structs, sizes))
    shapes = _shapes(structs)
    for path, spec in specs.items():
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
            assert shapes[path][dim] % n == 0, (path, shapes[path], ax)


@pytest.mark.parametrize("batch_size", [128, 1])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b",
                                  "zamba2-2.7b", "rwkv6-1.6b"])
def test_cache_specs_match_repro(arch, mesh_name, batch_size):
    """KV caches: batch over the batch axes and S over 'model' when B
    divides; at B 1 S over the batch axes and 'model' (sequence
    parallelism); recurrent states by batch where it divides."""
    sizes = MESHES[mesh_name]
    jmesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    want = _repro_specs(j_sharding.make_cache_pspecs(
        jmesh, j_steps.cache_specs(j_get_config(arch), batch_size, 4096),
        batch_size))
    got = _port_specs(sharding.make_cache_pspecs(
        sizes, steps.cache_specs(get_config(arch), batch_size, 4096),
        batch_size))
    assert got == want


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "lion", "sgdm"])
@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b"])
def test_state_pspec_matches_repro(arch, opt_name):
    sizes = MESHES["single"]
    j_structs = j_steps.param_specs(j_get_config(arch))
    j_spec = j_sharding.make_param_pspecs(j_structs, sizes)
    want = j_state_pspec(j_make_optimizer(opt_name, 1e-3).name, j_spec,
                         j_structs)
    structs = steps.param_specs(get_config(arch))
    got = state_pspec(opt_name, sharding.make_param_pspecs(structs, sizes),
                      structs)
    assert type(got).__name__ == type(want).__name__
    w = _repro_specs(want)
    g = _port_specs(got)
    assert g.keys() == w.keys()
    for path, spec in w.items():
        assert g[path] == spec, (path, g[path], spec)


def test_placements_put_pod_outermost():
    from torch.distributed.tensor import Replicate, Shard
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    mesh = Mesh()
    assert sharding_hints.placements(mesh, (("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding_hints.placements(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding_hints.placements(mesh, (("model", "data"),))
