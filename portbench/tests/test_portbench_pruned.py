"""The pruned ResNet-50 cell (``resnet50_sparse``): its plain reference
against the port's plain path, its masks against the port's bit for bit,
its table of the work against the port's layer tables, faults planted in
the port's pruning caught by ``correct``, and ``host_prune_ms``'s reader.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, hostspans, spec
from portbench.archs import pruning, resnet_v1_pruned
from portbench.reference import resnet_v1_pruned as reference
from portbench.tests.conftest import tiny_config, write
from portbench.tests.test_portbench_hostspans import (ANCHOR, OPS, WINDOW,
                                                      _reading, _span)

CELL = "resnet50_sparse.single_stream"
TINY = "tiny_resnet50_sparse.tiny_single"


def _tiny_config() -> dict:
    cfg = tiny_config("resnet50")
    cfg.update(arch="resnet_v1_pruned", keep_fraction=0.5)
    return cfg


def _draw(cfg: dict, seed: int, n: int = 3):
    gen = torch.Generator().manual_seed(seed)
    params = resnet_v1_pruned.draw(cfg, gen, "cpu")
    return params, torch.randn((n, cfg["image_size"], cfg["image_size"], 3),
                               generator=gen)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_reference_matches_the_ports_plain_path(seed):
    from repro_torch.models import cnn
    cfg = _tiny_config()
    params, x = _draw(cfg, seed)
    want = reference.forward(cfg, params, x)
    got = cnn.resnet50_apply(params, x, impl="ref", keep_fractions=0.5)
    assert want.shape == (3, 10)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # pruning changes the answer: the reference does not run the dense net
    dense = cnn.resnet50_apply(params, x, impl="ref")
    assert (dense - want).abs().max() > 1e-2 * want.abs().max()


@pytest.mark.parametrize("seed", [1, 3_000_000_019, 2**31 + 5])
def test_the_reference_masks_equal_the_ports_at_full_width(seed):
    from repro_torch.models import cnn
    cfg = spec.cell(CELL).config
    gen = torch.Generator().manual_seed(seed)
    params = resnet_v1_pruned.draw(cfg, gen, "cpu")
    _, ports = cnn.resnet50_prune(params, cfg["keep_fraction"])
    ours = reference.masks(cfg, params)
    assert set(ours) == set(ports) and len(ours) == 16
    for key, (m1, m2) in ours.items():
        assert m1 == np.flatnonzero(ports[key][0]).tolist(), key
        assert m2 == np.flatnonzero(ports[key][1]).tolist(), key
    mids = [len(ours[f"{g['name']}_b0"][0]) for g in cfg["groups"]]
    assert mids == [32, 64, 128, 256]


def test_the_reference_keeps_the_lowest_index_of_a_tie():
    w = torch.tensor([[1.0, -2.0, 2.0, 0.5], [1.0, 0.0, 0.0, -0.5]])
    assert reference.importance(w) == [2.0, 2.0, 2.0, 1.0]
    assert reference.mask(w, 0.5) == [0, 1]
    assert reference.mask(w, 0.1) == [0]


def test_the_pruned_layer_table_is_the_ports():
    from repro_torch.core import networks
    cfg = spec.cell(CELL).config
    ops = {o.name: o for o in resnet_v1_pruned.layers(cfg, 1)
           if o.kind == "conv"}
    main = networks.resnet50_conv_layers(sparse=True)
    assert len(main) == 49 and len(ops) == 53
    for layer in main:
        assert ops[layer.name].macs == layer.dense_macs, layer.name
    proj = sum(o.macs for n, o in ops.items() if n.endswith("_proj"))
    assert proj == sum(
        l.dense_macs for l in networks.resnet50_projection_shortcuts())
    assert round(sum(l.dense_macs for l in main) / 1e9, 3) == 1.345
    assert round(proj / 1e9, 3) == 0.360
    flops = sum(o.model_flops for o in resnet_v1_pruned.layers(cfg, 1))
    assert round(flops / 1e9, 2) == 3.41


@pytest.fixture
def pruned_root(tiny_root):
    write(tiny_root, "configs", "tiny_resnet50_sparse", _tiny_config())
    write(tiny_root, "workloads", TINY,
          {"config": "tiny_resnet50_sparse", "traffic": "tiny_single",
           "chips": 1, "why": "a CPU test", "limits": {"logit_err": 2e-5}})
    return tiny_root


def _run(root, engine="program", trace=False):
    return harness.run_cell(TINY, 2**31 + 3, 0.2, trace, device="cpu",
                            root=root, engine=engine, log=lambda s: None)


def test_a_sound_run_is_correct_and_the_control_is_not(pruned_root):
    r = _run(pruned_root)
    assert r["correct"] and r["attempted"] > 0
    assert r["check"]["logit_err"]["value"] < 1e-6
    r = _run(pruned_root, engine="reference_tf32")
    assert not r["correct"] and r["check"]["logit_err"]["value"] > 3e-5
    # no device trace on the CPU: the new reader reads nothing
    r = _run(pruned_root, trace=True)
    assert r["correct"] and set(r["metrics"]) == {"enqueue_ms"}


def _shifted_mask(monkeypatch):
    """Every mask of the port moved by one channel."""
    from repro_torch.models import cnn
    topk = cnn.topk_channel_mask
    monkeypatch.setattr(cnn, "topk_channel_mask",
                        lambda w, keep: np.roll(topk(w, keep), 1))


def _3x3_inputs_by_m2(monkeypatch):
    """The 3x3's input channels taken by its own output mask."""
    from repro_torch.models import cnn
    prune = cnn.prune_conv_weights

    def broken(w, keep_out=None, keep_in=None):
        if keep_out is not None and keep_in is not None:
            keep_in = keep_out
        return prune(w, keep_out, keep_in)
    monkeypatch.setattr(cnn, "prune_conv_weights", broken)


@pytest.mark.parametrize("fault", [_shifted_mask, _3x3_inputs_by_m2])
def test_a_fault_in_the_ports_pruning_is_caught(pruned_root, monkeypatch,
                                                fault):
    from repro_torch.models import cnn, cnn_graph
    fault(monkeypatch)
    cnn_graph.reset(cnn.resnet50_apply)
    r = _run(pruned_root)
    cnn_graph.reset(cnn.resnet50_apply)
    assert not r["correct"] and r["failed"] == r["attempted"]


def test_the_pruned_program_imports_no_jax():
    """The cell's program and reference run a forward in a fresh
    interpreter, as a run does, and load neither JAX nor the JAX package."""
    code = f"""
import json, sys
sys.path[:0] = [{str(spec.ROOT.parent / 'src')!r}, {str(spec.ROOT.parent)!r}]
import torch
from portbench import harness, spec
from portbench.tests.test_portbench_pruned import _draw, _tiny_config
cfg = _tiny_config()
params, x = _draw(cfg, 0, 1)
c = spec.cell({CELL!r})
y = c.arch().program(cfg)(params, x)
want = c.reference().forward(cfg, params, x)
assert (y - want).abs().max() <= 1e-5 * want.abs().max()
print(json.dumps(harness.forbidden_modules()))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.splitlines()[-1]) == []


def test_the_program_refuses_a_keep_fraction_it_cannot_prune():
    cfg = {**spec.cell(CELL).config, "keep_fraction": 1.0}
    with pytest.raises(ValueError):
        resnet_v1_pruned.program(cfg)


def _prune_passes(durations_us):
    """Passes of one forward each, with a cnn.prune span of each duration
    (none where the duration is None)."""
    roots = [_span("cnn.forward", 0, 100,
                   [] if d is None else [_span("cnn.prune", 1, 1 + d)])
             for d in durations_us]
    return hostspans.Passes(len(roots), [0.1] * len(roots), roots, roots,
                            ANCHOR, OPS, WINDOW)


@pytest.mark.parametrize("cell,durations,want", [
    (CELL, [10, 30, 20], 0.020),
    ("resnet50.single_stream", [None, None], 0.0),
    ("vgg16.single_stream", [None], 0.0)])
def test_host_prune_ms_reads_the_prune_spans(monkeypatch, cell, durations,
                                             want):
    m = spec.metric("host_prune_ms")
    monkeypatch.setattr(hostspans, "run",
                        lambda c: _prune_passes(durations))
    r = _reading(cell)
    assert m.reports(r.cell) and pruning.has_prune_span()
    assert m.read(r) == pytest.approx(want)


def test_host_prune_ms_reads_none_where_the_run_has_nothing(monkeypatch):
    from repro_torch.models import cnn
    m = spec.metric("host_prune_ms")
    monkeypatch.setattr(hostspans, "run", lambda c: _prune_passes([10]))
    # no device trace (no CUDA)
    assert m.read(_reading(CELL, profile=False)) is None
    # a program that keeps no pruned set and records no cnn.prune span
    monkeypatch.delattr(cnn.resnet50_apply, "prune_hits")
    assert not pruning.has_prune_span()
    assert m.read(_reading(CELL)) is None
