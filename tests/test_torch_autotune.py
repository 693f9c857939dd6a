"""Port parity: the tuning cache (``repro_torch.core.autotune``), the plan
override through the dispatch, and the tuner's CPU-side logic.

Mirrors ``tests/test_autotune.py`` where the test applies to the port's plan
space (block tile and split count of the pipelined CUDA kernels, not the
Pallas ``bm/bk/bc``).  Every test isolates the cache behind tmp dirs
(``REPRO_TORCH_TUNED_TABLES_DIR`` / ``REPRO_TORCH_AUTOTUNE_CACHE``) and
restores the enable flag, so the suite never sees the repo's committed
tables or a user cache.  On the CPU every wrapper runs its plain version,
so a tuned plan changes the spans and the plan, never the numbers: outputs
are compared to the plain result exactly (tolerance 0).
"""
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import autotune as j_tuner
from repro.core import autotune as j_autotune
from repro.core import networks as j_nets
from repro_torch.core import autotune, carla, networks
from repro_torch.core.autotune import (
    AS,
    WS,
    Entry,
    TileConfig,
    conv2d_key,
    gemm_key,
)
from repro_torch.core.fuse import Epilogue
from repro_torch.core.modes import Dataflow, Stationarity
from repro_torch.kernels import _build, ops
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import matmul as t_mm
from repro_torch.launch import tune
from repro_torch.observability import trace


@pytest.fixture
def iso(tmp_path, monkeypatch):
    """Isolated cache dirs + clean in-memory state + restored enable flag."""
    tables, cache = tmp_path / "tables", tmp_path / "cache"
    tables.mkdir()
    cache.mkdir()
    monkeypatch.setenv("REPRO_TORCH_TUNED_TABLES_DIR", str(tables))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(cache))
    was = autotune.enabled()
    autotune.reset()
    yield {"tables": tables, "cache": cache}
    autotune.reset()
    (autotune.enable if was else autotune.disable)()


def _write_table(path, entries, *, kernel_hash=None, backend=None,
                 device=None):
    doc = {"version": 1, "backend": backend or autotune.backend(),
           "device": device or autotune.device_name(), "impl": "cuda",
           "kernel_hash": kernel_hash or autotune.kernel_signature_hash(),
           "entries": {k: {"config": cfg.to_dict()}
                       for k, cfg in entries.items()}}
    path.write_text(json.dumps(doc))


NETS = ("resnet50", "resnet50_sparse", "vgg16", "smoke", "smoke_sparse")


def _layers(name):
    """One layer table of the port and of ``repro``, layer by layer."""
    sparse = name.endswith("_sparse")

    def table(nets):
        if name.startswith("resnet50"):
            return (nets.resnet50_conv_layers(sparse)
                    + nets.resnet50_projection_shortcuts(sparse))
        if name == "vgg16":
            return nets.vgg16_conv_layers()
        return nets.smoke_conv_layers(sparse)
    return table(networks), table(j_nets)


# ----------------------------- keys + config ---------------------------------
@pytest.mark.parametrize("batch", (1, 2, 8))
@pytest.mark.parametrize("name", NETS)
def test_keys_are_repros_for_every_layer(name, batch):
    """Every layer's key at batch 1, 2 and 8 is the string ``repro``'s tuner
    and dispatch use: ``benchmarks/autotune.py``'s table keys, and the
    dispatch keys of a fused epilogue, whose ``ep:none`` fallback is that
    table key."""
    port, jax_side = _layers(name)
    assert len(port) == len(jax_side) > 0
    for tl, jl in zip(port, jax_side):
        assert tl.name == jl.name
        assert tune.layer_key(tl, batch) == j_tuner._layer_key(jl, batch)
        assert tune.gemm_rows(tl, batch) == j_tuner._gemm_rows(jl, batch)
        x_shape = (batch, tl.IL, tl.IL, tl.IC)
        w_shape = (tl.FL, tl.FL, tl.IC, tl.K)
        x = torch.zeros(0, dtype=torch.bfloat16)
        for tag in ("none", "scale+bias+relu"):
            assert (conv2d_key(x_shape, w_shape, tl.S, tl.Z,
                               ops.dtype_name(x), tag)
                    == j_autotune.conv2d_key(x_shape, w_shape, tl.S, tl.Z,
                                             jnp.bfloat16(0).dtype, tag))
            m = tune.gemm_rows(tl, batch)
            key = gemm_key(m, tl.IC, tl.K, "float32", tag)
            assert key == j_autotune.gemm_key(m, tl.IC, tl.K,
                                              jnp.float32(0).dtype, tag)
            assert autotune._ep_none(key) == j_autotune._ep_none(key)


def test_key_formats_are_stable():
    assert (conv2d_key((1, 14, 14, 8), (3, 3, 8, 16), 1, 1, "float32")
            == "conv2d|x1x14x14x8|f3x3x16|s1p1|float32|ep:none")
    assert (gemm_key(784, 16, 8, "float32", "bias+relu")
            == "gemm|m784|c16|k8|float32|ep:bias+relu")


def test_tileconfig_roundtrip_and_labels():
    cfg = TileConfig(tile=2, splits=6, stationarity=WS)
    assert TileConfig.from_dict(cfg.to_dict()) == cfg
    assert TileConfig.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg
    assert cfg.short == "64x64g4/s6/ws"
    assert TileConfig(0, 1, AS).short == "128x64g1/s1/as"
    assert TileConfig(1, 3).short == "64x64g1/s3"
    assert TileConfig(1, 3).to_dict() == {"tile": 1, "splits": 3}
    assert len({cfg, TileConfig(2, 6, WS), TileConfig(2, 6)}) == 2


def test_kernel_signature_hash_is_the_sources_hash():
    """A table's hash covers what its plans depend on: the tunable CNN
    kernels' sources and headers and the nvcc flags, not every source."""
    assert set(autotune.TUNED_SOURCES) == {
        "conv2d.cu", "matmul.cu", "gemm_pipe.cuh", "numeric.cuh", "ptx.cuh"}
    assert autotune.kernel_signature_hash() == _build.source_hash(
        autotune.TUNED_SOURCES)
    assert autotune.kernel_signature_hash() != _build.source_hash()


def test_kernel_signature_hash_ignores_other_kernels(tmp_path, monkeypatch):
    """On copies of csrc/: an edit of the decode kernel leaves the tables'
    hash as it is, an edit of the CNN loop changes it; the build
    directory's hash follows both."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    table0, build0 = autotune.kernel_signature_hash(), _build.source_hash()
    with open(csrc / "decode_attention.cu", "a") as f:
        f.write("\n// edited\n")
    table1, build1 = autotune.kernel_signature_hash(), _build.source_hash()
    assert table1 == table0 and build1 != build0
    with open(csrc / "gemm_pipe.cuh", "a") as f:
        f.write("\n// edited\n")
    assert autotune.kernel_signature_hash() != table0
    assert _build.source_hash() != build1


# ------------------------------ candidates -----------------------------------
def _candidates(layer):
    return tune.candidates(layer, _build.REFERENCE_SMS, 8)


@pytest.mark.parametrize("name", NETS)
def test_candidates_are_plans_the_launch_takes(name):
    """Each candidate is a GemmPlan that keeps the C side's invariants; the
    first is the analytic plan; 1x1 layers offer both stationarities, and a
    weight-stationary plan holds the rows in the fewest row tiles."""
    for layer in _layers(name)[0]:
        cands = _candidates(layer)
        assert 1 <= len(cands) <= 8 and len(set(cands)) == len(cands)
        if layer.FL == 1:
            m, n, r, vec = (tune.gemm_rows(layer), layer.K, layer.IC,
                            layer.IC % _build.PIPE_BK == 0)
            st = "weight_stationary" if m < 128 else "activation_stationary"
            planner = (_build.plan_weight_stationary if st == WS
                       else _build.plan_gemm)
            assert {c.stationarity for c in cands} == {WS, AS}
            assert cands[0].stationarity == st
        else:
            m, n, r, vec = autotune.conv2d_shape(
                (1, layer.IL, layer.IL, layer.IC),
                (layer.FL, layer.FL, layer.IC, layer.K), layer.S, layer.Z)
            planner = _build.plan_gemm
        analytic = planner(m, n, r, _build.REFERENCE_SMS, vec)
        assert (cands[0].tile, cands[0].splits) == (analytic.tile,
                                                    analytic.splits)
        for c in cands:
            p = _build.fixed_plan(c.tile, c.splits, r, vec)
            assert (p.bm, p.bn, p.groups) == _build.PIPE_TILES[c.tile]
            assert p.splits == c.splits and p.vec == vec
            assert p.per % _build.PIPE_BK == 0
            assert (p.splits - 1) * p.per < r <= p.splits * p.per
            if p.splits > 1:
                assert p.per >= _build.PIPE_BK * _build.MIN_CHUNKS_PER_SPLIT
            if not vec:
                assert min(p.per, r) <= _build.PIPE_TABLE_MAX
            if c.stationarity == WS:
                assert c.tile in _build.ws_codes(m)


def test_candidates_are_ranked_by_the_latency_model():
    layer = networks.vgg16_conv_layers()[5]
    m, n, r, vec = autotune.conv2d_shape((1, 56, 56, 256), (3, 3, 256, 256))
    cands = _candidates(layer)[1:]
    cycles = [_build.pipe_cycles(m, n, _build.fixed_plan(c.tile, c.splits,
                                                         r, vec), 132)
              for c in cands]
    assert cycles == sorted(cycles) and len(cands) == 7


def test_fixed_plan_refuses_what_the_launch_refuses():
    assert _build.fixed_plan(0, 3, 147, False).per == 64
    with pytest.raises(ValueError, match="cannot take 4 splits"):
        _build.fixed_plan(0, 4, 48, True)      # 3 chunks cannot make 4
    with pytest.raises(ValueError, match="general path"):
        _build.fixed_plan(1, 1, 4608, False)   # past the index table
    with pytest.raises(ValueError, match="no pipelined plan"):
        _build.fixed_plan(3, 1, 64, True)
    x, w = torch.zeros(1, 14, 14, 64), torch.zeros(3, 3, 64, 64)
    with pytest.raises(ValueError, match="cannot take"):
        t_conv.launch_plan(x, w, padding=1, tiles=TileConfig(0, 100))
    assert t_conv.launch_plan(x, w, padding=1, tiles=TileConfig(2, 4)) == \
        _build.fixed_plan(2, 4, 576, True)
    assert t_mm.ws_plan(torch.zeros(49, 512), torch.zeros(512, 64),
                        tiles=TileConfig(1, 2, WS)).per == 256


# --------------------------- cache + persistence ------------------------------
def test_lookup_precedence_table_cache_runtime(iso):
    key = gemm_key(100, 64, 32, "float32")
    _write_table(iso["tables"] / "net.h100.json", {key: TileConfig(0, 1)})
    autotune.reset()
    assert autotune.lookup(key).source == "table"
    assert autotune.lookup(key).config == TileConfig(0, 1)

    _write_table(iso["cache"] / f"cache.{autotune.backend()}.json",
                 {key: TileConfig(1, 1)})
    autotune.reset()
    assert autotune.lookup(key).source == "cache"
    assert autotune.lookup(key).config == TileConfig(1, 1)

    autotune.put(key, TileConfig(2, 1))
    assert autotune.lookup(key).source == "runtime"
    assert autotune.lookup(key).config == TileConfig(2, 1)


def test_epilogue_fallback_lookup(iso):
    base = gemm_key(100, 64, 32, "float32")
    autotune.put(base, TileConfig(1, 1))
    fused = gemm_key(100, 64, 32, "float32", "scale+bias+relu")
    assert autotune.lookup(fused).config == TileConfig(1, 1)
    autotune.put(fused, TileConfig(2, 1))
    assert autotune.lookup(fused).config == TileConfig(2, 1)
    assert autotune.lookup(gemm_key(101, 64, 32, "float32")) is None


def test_stale_table_rejected_and_reported(iso):
    key = gemm_key(100, 64, 32, "float32")
    _write_table(iso["tables"] / "old.json", {key: TileConfig(0, 1)},
                 kernel_hash="deadbeef00000000")
    autotune.reset()
    assert autotune.lookup(key) is None
    (stale,) = autotune.stale_tables()
    assert stale["table_hash"] == "deadbeef00000000"
    assert stale["current_hash"] == autotune.kernel_signature_hash()
    assert stale["path"].endswith("old.json")


@pytest.mark.parametrize("header", [{"backend": "rocm"},
                                    {"device": "NVIDIA A100-SXM4-80GB"}])
def test_other_backend_or_device_table_skipped(iso, header):
    key = gemm_key(100, 64, 32, "float32")
    _write_table(iso["tables"] / "other.json", {key: TileConfig(0, 1)},
                 **header)
    autotune.reset()
    assert autotune.lookup(key) is None
    assert autotune.stale_tables() == []   # another card is not "stale"


def test_save_user_cache_merges(iso):
    k1, k2 = gemm_key(10, 16, 8, "float32"), gemm_key(20, 16, 8, "float32")
    autotune.save_user_cache({k1: Entry(TileConfig(1, 1), "cache", 0.5, 1.0)})
    path = autotune.save_user_cache({k2: Entry(TileConfig(2, 1))})
    autotune.reset()
    assert autotune.lookup(k1).config == TileConfig(1, 1)
    assert autotune.lookup(k1).default_ms == 1.0
    assert autotune.lookup(k2).config == TileConfig(2, 1)
    doc = json.loads(open(path).read())
    assert (doc["backend"], doc["device"], doc["kernel_hash"]) == (
        autotune.backend(), autotune.device_name(),
        autotune.kernel_signature_hash())
    assert set(doc) >= {"power_limit", "entries", "version"}


def test_committed_tables_carry_the_current_hash():
    """A table under kernels/tuned/ was measured with today's sources."""
    for path in sorted(Path(autotune.tables_dir()).glob("*.json")):
        doc = json.loads(path.read_text())
        assert doc["kernel_hash"] == autotune.kernel_signature_hash(), \
            path.name
        assert doc["backend"] == "cuda" and "H100" in doc["device"]


# ------------------------------- tile_util ------------------------------------
def test_tile_util_describes_the_tile_that_ran():
    x_shape, w_shape = (1, 14, 14, 64), (3, 3, 64, 64)
    # 196 rows in 64-row tiles pad to 256; in 128-row tiles also to 256
    assert autotune.tile_util_conv2d(x_shape, w_shape, 1, 1,
                                     TileConfig(1, 1)) == 196 / 256
    assert autotune.tile_util_conv2d(x_shape, w_shape, 1, 1,
                                     TileConfig(0, 2)) == 196 / 256
    # 49 rows: 64 in a 64-row tile, 128 in a 128-row tile
    assert autotune.tile_util_gemm(49, 512, 64, TileConfig(1, 2, WS)) == \
        49 / 64
    assert autotune.tile_util_gemm(49, 512, 64, TileConfig(0, 2, AS)) == \
        49 / 128
    assert autotune.tile_util_gemm(49, 512, 64, None, WS) == 49 / 64


# ------------------------- dispatch + plan integration ------------------------
def _nhwc(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_disabled_cache_never_consulted(iso, monkeypatch):
    key = gemm_key(4 * 7 * 7, 16, 16, "float32")
    autotune.put(key, TileConfig(1, 1, WS))
    autotune.disable()
    calls = []
    monkeypatch.setattr(autotune, "lookup",
                        lambda *a: calls.append(a) or None)
    x, w = _nhwc(0, 4, 7, 7, 16), _nhwc(1, 1, 1, 16, 16)
    with trace.capture() as tr:
        carla.carla_conv(x, w)
    assert calls == []
    sp = tr.spans[0]
    assert sp.attrs["tuned"] is False
    assert sp.attrs["tile_config"] == "default"
    assert sp.attrs["tuning_source"] == "analytic"
    assert sp.children[-1].attrs["tuned"] is False


def test_tuned_stationarity_flips_effective_dataflow(iso):
    autotune.enable()
    x_shape, w_shape = (1, 28, 28, 16), (1, 1, 16, 32)
    plan = carla.plan_conv(x_shape, w_shape)
    assert plan.dataflow == Dataflow.CONV1X1_FEATURE_STATIONARY
    assert plan.tile_config is None and plan.tuning_source == "analytic"
    autotune.put(gemm_key(28 * 28, 16, 32, "float32"), TileConfig(0, 1, WS))
    plan = carla.plan_conv(x_shape, w_shape)
    # the analytic ledger is unchanged; only the effective dataflow moves
    assert plan.dataflow == Dataflow.CONV1X1_FEATURE_STATIONARY
    assert plan.effective_dataflow == Dataflow.CONV1X1_WEIGHT_STATIONARY
    assert plan.tuning_source == "runtime"


@pytest.mark.parametrize("stride", [1, 2])
def test_tuned_spans_and_cpu_output(iso, stride):
    """A runtime put makes the carla_conv span say tuned=True with the
    tuned tile and stationarity; the CPU output is still the plain
    result, bit for bit."""
    autotune.enable()
    x, w = _nhwc(2, 1, 28, 28, 16), _nhwc(3, 1, 1, 16, 32)
    rows = (-(-28 // stride)) ** 2
    cfg = TileConfig(0, 1, WS)
    ep = Epilogue(relu=True)
    autotune.put(gemm_key(rows, 16, 32, "float32", ep.tag), cfg)
    with trace.capture() as tr:
        out = carla.carla_conv(x, w, stride=stride, epilogue=ep)
    want = t_mm.matmul_plain(x, w[0, 0], stride=stride, relu=True)
    assert torch.equal(out, want)
    sp = tr.spans[0]
    assert sp.attrs["tuned"] is True
    assert sp.attrs["tile_config"] == "128x64g1/s1/ws"
    assert sp.attrs["tuning_source"] == "runtime"
    assert sp.attrs["effective_dataflow"] == \
        Dataflow.CONV1X1_WEIGHT_STATIONARY.value
    assert sp.attrs["dataflow"] == Dataflow.CONV1X1_FEATURE_STATIONARY.value
    assert sp.attrs["tile_util"] == autotune.tile_util_gemm(rows, 16, 32, cfg)
    # the plain engine has no plan: the kernel span reports no tuning
    (_, ksp) = sp.children
    assert ksp.attrs["impl"] == "ref" and ksp.attrs["tuned"] is False


def test_tuned_conv2d_span(iso):
    autotune.enable()
    x, w = _nhwc(4, 1, 10, 10, 16), _nhwc(5, 3, 3, 16, 24)
    autotune.put(conv2d_key(x.shape, w.shape, 1, 1, "float32"),
                 TileConfig(2, 3))
    with trace.capture() as tr:
        out = carla.carla_conv(x, w, padding=1)
    assert torch.equal(out, t_conv.conv2d_plain(x, w, padding=1))
    sp = tr.spans[0]
    assert (sp.attrs["tuned"], sp.attrs["tile_config"]) == (True,
                                                            "64x64g4/s3")
    assert sp.attrs["tile_util"] == pytest.approx(100 * 24 / (128 * 64))


def test_kernel_dispatch_looks_up_on_the_cuda_engine_only(iso, monkeypatch):
    """The decision reads the cache on any engine; only the cuda engine's
    launch takes the tuned plan: on the ref engine the kernel span reports
    no tuning (no plan ran), under the decided stationarity."""
    autotune.enable()
    autotune.put(gemm_key(49, 64, 32, "float32"), TileConfig(1, 1, AS))
    x, w = _nhwc(6, 49, 64), _nhwc(7, 64, 32)
    assert autotune.decide(x.shape, w.shape, cache=False).entry is None
    d = autotune.decide(x.shape, w.shape, epilogue="relu")
    assert d.entry.config == d.tiles == TileConfig(1, 1, AS)
    # the tuned stationarity decides which route the cuda engine takes;
    # an explicit one outranks it, the rule (49 rows < 128) comes last
    assert (d.route, d.stationarity.value) == (autotune.MM_AS, AS)
    assert autotune.decide(x.shape, w.shape, cache=False).route == \
        autotune.MM_WS
    assert autotune.decide(
        x.shape, w.shape, stationarity=Stationarity(WS)).route == \
        autotune.MM_WS
    assert autotune.launch_plan(d, x, w, n_sms=132) == \
        _build.fixed_plan(1, 1, 64, True)
    with trace.capture() as tr:
        out = ops.gemm(x, w)
    assert torch.equal(out, t_mm.matmul_plain(x, w))
    a = tr.spans[0].attrs
    assert (a["impl"], a["tuned"], a["tile_config"]) == ("ref", False,
                                                         "default")
    assert a["stationarity"] == AS


# ------------------------------- the tuner ------------------------------------
def _rec(short, rounds, ok=True):
    return {"short": short, "config": short, "rounds": rounds, "ok": ok}


def test_tuner_winner_must_beat_the_spread():
    analytic = _rec("a", [1.0, 1.1, 0.9])
    # 0.85 beats 1.0 by less than the analytic plan's spread (0.2)
    assert tune.choose([analytic, _rec("b", [0.85, 0.85, 0.85])]) is analytic
    fast = _rec("c", [0.5, 0.6, 0.55])
    assert tune.choose([analytic, _rec("b", [0.85] * 3), fast]) is fast
    assert fast["ms"] == 0.55 and analytic["spread"] == pytest.approx(0.2)
    # a candidate that failed its check never wins
    wrong = _rec("d", [], ok=False)
    assert tune.choose([analytic, wrong]) is analytic


def test_tuner_tolerance_is_chip_smokes():
    import chip_smoke
    for dtype in (torch.float32, torch.bfloat16):
        want = _nhwc(8, 64, 64).to(dtype)
        assert tune.tolerance(want, 576) == chip_smoke._tol(want, 576)


def test_tuner_layer_sets_and_table_name():
    assert len(tune.net_layers("resnet50")) == 53
    assert len({tune.layer_key(l) for l in tune.net_layers("resnet50",
                                                           True)}) == 36
    assert len({tune.layer_key(l) for l in tune.net_layers("vgg16")}) == 9
    with pytest.raises(KeyError):
        tune.net_layers("vgg16", sparse=True)
    assert tune.table_name("resnet50").startswith("resnet50.")


def test_tuner_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tuner would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["--net", "smoke"])


@pytest.mark.parametrize("argv,want", [
    (["--net", "vgg16", "--batch", "2", "--reps", "3", "--candidates", "4",
      "--verbose"],
     dict(net="vgg16", batch=2, reps=3, max_candidates=4, verbose=True)),
    (["--net", "resnet50", "--batch", "8"],
     dict(net="resnet50", batch=8, reps=tune.REPS,
          max_candidates=tune.CANDIDATES, verbose=False)),
    # --smoke: the smoke layer set on the least budget, whatever --net says
    (["--net", "vgg16", "--smoke", "--candidates", "6", "--reps", "4"],
     dict(net="smoke", batch=1, reps=1, max_candidates=3, verbose=False)),
])
def test_tuner_options_reach_tune_layers(monkeypatch, tmp_path, argv, want):
    """The parsed options reach ``tune_layers`` with ``repro``'s meaning
    (``benchmarks/autotune.py``), and ``--out`` writes the table there,
    over ``--commit``; the keys are the batch's.  The card is stubbed out:
    the tuner itself still refuses to run without one
    (``test_tuner_needs_the_card``)."""
    seen = {}

    def fake_tune_layers(layers, **kw):
        seen.update(kw, layers=layers)
        cfg = TileConfig(tile=0, splits=1)
        entries = {tune.layer_key(l, kw["batch"]):
                   Entry(config=cfg, source="cache", tuned_ms=1.0,
                         default_ms=1.0) for l in layers}
        return entries, {k: [{"config": cfg}] for k in entries}

    monkeypatch.setattr(tune, "resolve_device", lambda d: d)
    monkeypatch.setattr(tune, "tune_layers", fake_tune_layers)
    out = tmp_path / "table.json"
    entries = tune.main(argv + ["--commit", "--out", str(out)])
    assert {k: seen[k] for k in ("batch", "reps", "max_candidates",
                                 "verbose")} == {
        k: want[k] for k in ("batch", "reps", "max_candidates", "verbose")}
    assert [l.name for l in seen["layers"]] == [
        l.name for l in tune.net_layers(want["net"])]
    doc = json.loads(out.read_text())
    assert doc["net"] == want["net"]
    assert sorted(doc["entries"]) == sorted(entries)
    b = want["batch"]
    assert all(k.startswith((f"conv2d|x{b}x", "gemm|m")) for k in entries)
    assert set(entries) == {j_tuner._layer_key(jl, b)
                            for jl in _layers(want["net"])[1]}


def test_tuner_refuses_counts_below_one():
    with pytest.raises(SystemExit):
        tune.main(["--net", "smoke", "--batch", "0"])


def test_tuner_keys_cover_every_traced_forward():
    """The layer tables the tuner walks give every key that a full-width
    forward of ResNet-50 (dense and sparse) and VGG-16 looks up."""
    from repro_torch.models import cnn
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 224, 224, 3)).astype(np.float32))
    r50 = cnn.resnet50_init(torch.Generator().manual_seed(0), device="cpu")
    vgg = cnn.vgg16_init(torch.Generator().manual_seed(1), device="cpu")
    for net, apply, params, kw in (
            ("resnet50", cnn.resnet50_apply, r50, {}),
            ("resnet50", cnn.resnet50_apply, r50, {"sparse": True}),
            ("vgg16", cnn.vgg16_apply, vgg, {})):
        keys = {tune.layer_key(l)
                for l in tune.net_layers(net, bool(kw))}
        with trace.capture() as tr:
            apply(params, x, impl="ref", **kw)
        spans = tr.find("carla_conv")
        assert spans
        for sp in spans:
            a = sp.attrs
            xs, ws = a["x_shape"], a["w_shape"]
            if ws[0] == 1:
                rows = xs[0] * -(-xs[1] // a["stride"]) * -(-xs[2]
                                                           // a["stride"])
                key = gemm_key(rows, ws[2], ws[3], "float32")
            else:
                key = conv2d_key(xs, ws, a["stride"], a["padding"],
                                 "float32")
            assert key in keys, (net, kw, key)
