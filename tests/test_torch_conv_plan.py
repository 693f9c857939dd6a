"""One plan per conv: the decision (``core.autotune.decide``) that the
launch, the ``carla_conv`` span, the kernel span and the tuner all read.

``tests/data/conv_plans.json`` holds the route, stationarity, tile, splits,
split length and gather path of every conv of ResNet-50 (dense and keep
0.5) and VGG-16 at 224x224, at batches 1, 16 and 64, on a card of 132 SMs,
with the vec16 path allowed and not, untuned and under the tuned entries it
lists, as the dispatch planned them before the decision was made in one
place.  The decision and the launch plan must give the same plans; a
change that moves a plan on purpose records the file again
(``PYTHONPATH=src python tests/test_torch_conv_plan.py``) and says which
plans moved.  On the card (``chip``, skipped without one) a
traced ResNet-50 forward launches the decided routes and both spans report
the launched plan's tile_util.
"""
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import autotune, carla, cost_model, modes
from repro_torch.core.autotune import TileConfig
from repro_torch.core.fuse import Epilogue
from repro_torch.core.modes import Dataflow
from repro_torch.kernels import _build, ops
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import matmul as t_mm
from repro_torch.models import cnn
from repro_torch.observability import trace

PLANS_FILE = Path(__file__).parent / "data" / "conv_plans.json"
PLANS = json.loads(PLANS_FILE.read_text())


@pytest.fixture
def iso(tmp_path, monkeypatch):
    """Empty tables and cache dirs, a clean live cache, the flag restored."""
    for name, env in (("tables", "REPRO_TORCH_TUNED_TABLES_DIR"),
                      ("cache", "REPRO_TORCH_AUTOTUNE_CACHE")):
        (tmp_path / name).mkdir()
        monkeypatch.setenv(env, str(tmp_path / name))
    was = autotune.enabled()
    autotune.reset()
    yield
    autotune.reset()
    (autotune.enable if was else autotune.disable)()


def _operands(case):
    """x and the filter the dispatch takes ((C, K) for a 1x1), on the meta
    device: only their shapes are read."""
    x = torch.empty(case["x"], device="meta")
    w = torch.empty(case["w"], device="meta")
    return x, (w[0, 0] if case["w"][0] == 1 else w)


@pytest.mark.parametrize("batch", [1, 16, 64])
@pytest.mark.parametrize("tuning", [False, True])
def test_every_main_path_conv_keeps_its_plan(iso, monkeypatch, tuning,
                                              batch):
    if tuning:
        autotune.enable()
        for key, cfg in PLANS["entries"].items():
            autotune.put(key, TileConfig.from_dict(cfg))
    else:
        autotune.disable()
    cases = [c for c in PLANS["cases"]
             if c["tuning"] == tuning and c["x"][0] == batch]
    assert len(cases) == 92
    for case in cases:
        monkeypatch.setattr(
            _build, "vec_path", lambda c, k, x, w, r, ok=case["vec_allowed"]:
            ok and c % 16 == 0 and k * x.element_size() % 16 == 0)
        x, w = _operands(case)
        plan = carla.plan_conv(tuple(case["x"]), tuple(case["w"]),
                               case["stride"], case["padding"],
                               epilogue_tag=case["epilogue"])
        d = plan.decision
        assert d == autotune.decide(x.shape, w.shape, case["stride"],
                                    case["padding"], "float32",
                                    case["epilogue"])
        launch = autotune.launch_plan(d, x, w, n_sms=PLANS["n_sms"])
        got = {"route": d.route,
               "stationarity": d.stationarity and d.stationarity.value,
               "entry": d.tiles.short if d.tiles else None,
               "tile": launch.tile, "splits": launch.splits,
               "per": launch.per, "vec": launch.vec}
        assert got == {k: case[k] for k in got}, case
        # the wrappers' own planners give the launch's plan
        kw = dict(stride=case["stride"], n_sms=PLANS["n_sms"], tiles=d.tiles)
        public = {"conv2d": lambda: t_conv.launch_plan(
                      x, w, padding=case["padding"], **kw),
                  autotune.MM_AS: lambda: t_mm.act_plan(x, w, **kw),
                  autotune.MM_WS: lambda: t_mm.ws_plan(x, w, **kw)}
        assert public[d.route]() == launch


def _nhwc(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


CALLS = {
    "carla_conv": lambda x, w3, w1: carla.carla_conv(x, w1),
    "carla_conv_3x3": lambda x, w3, w1: carla.carla_conv(x, w3, padding=1),
    "ops.conv2d": lambda x, w3, w1: ops.conv2d(x, w3, padding=1),
    "ops.conv1x1": lambda x, w3, w1: ops.conv1x1(x, w1[0, 0], stride=2),
    "ops.gemm": lambda x, w3, w1: ops.gemm(x.reshape(-1, 16), w1[0, 0]),
}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_one_cache_read_a_dispatch(iso, monkeypatch, call, traced):
    autotune.enable()
    reads = []
    real = autotune.lookup
    monkeypatch.setattr(autotune, "lookup",
                        lambda key: reads.append(key) or real(key))
    x = _nhwc(0, 2, 8, 8, 16)
    w3, w1 = _nhwc(1, 3, 3, 16, 24), _nhwc(2, 1, 1, 16, 24)
    if traced:
        with trace.capture():
            CALLS[call](x, w3, w1)
    else:
        CALLS[call](x, w3, w1)
    assert len(reads) == 1, reads


@pytest.mark.parametrize("fl", [1, 3])
def test_an_untraced_dispatch_never_runs_the_asic_model(monkeypatch, fl):
    def refuse(*a, **k):
        raise AssertionError("the ASIC model ran")
    monkeypatch.setattr(cost_model, "layer_cost", refuse)
    monkeypatch.setattr(modes, "select_dataflow", refuse)
    x, w = _nhwc(3, 1, 8, 8, 16), _nhwc(4, fl, fl, 16, 32)
    out = carla.carla_conv(x, w, padding=fl // 2)
    assert out.shape == (1, 8, 8, 32)
    # the ledger reads it once a traced dispatch has run
    with pytest.raises(AssertionError, match="ASIC model"):
        with trace.capture():
            carla.carla_conv(x, w, padding=fl // 2)


def test_the_spans_of_one_dispatch_agree_at_batch_16():
    """conv5's 1x1 at batch 16: the paper's rule (7 x 7 < 196 PEs) says
    weight-stationary, the 784 rows run activation-stationary; the
    carla_conv span names the kernel that ran."""
    x, w = _nhwc(5, 16, 7, 7, 512), _nhwc(6, 1, 1, 512, 2048)
    with trace.capture() as tr:
        carla.carla_conv(x, w, epilogue=Epilogue(relu=True))
    (sp,) = tr.spans
    (_, ksp) = sp.children
    assert ksp.name == "kernels.conv1x1"
    assert sp.attrs["dataflow"] == Dataflow.CONV1X1_WEIGHT_STATIONARY.value
    assert ksp.attrs["stationarity"] == "activation_stationary"
    assert sp.attrs["effective_dataflow"] == \
        Dataflow.CONV1X1_FEATURE_STATIONARY.value
    assert sp.attrs["tile_util"] == ksp.attrs["tile_util"] == \
        autotune.tile_util_gemm(784, 512, 2048,
                                stationarity="activation_stationary")
    for key in ("bytes_touched", "epilogue", "epilogue_hbm_saved"):
        assert sp.attrs[key] == ksp.attrs[key], key


# ----------------------------------------------------------- on the card ---
@pytest.mark.chip
@pytest.mark.parametrize("tuning", [False, True])
@pytest.mark.parametrize("batch", [1, 16])
def test_the_card_launches_the_decided_plans(batch, tuning):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    was = autotune.enabled()
    autotune.reset()
    (autotune.enable if tuning else autotune.disable)()
    try:
        params = cnn.resnet50_init(torch.Generator().manual_seed(0))
        x = torch.randn((batch, 224, 224, 3), device="cuda")
        with trace.capture() as tr:
            cnn.resnet50_apply(params, x)
        torch.cuda.synchronize()
        spans = tr.find("carla_conv")
        assert len(spans) == 53
        tuned = 0
        for sp in spans:
            a = sp.attrs
            plan = carla.plan_conv(tuple(a["x_shape"]), tuple(a["w_shape"]),
                                   a["stride"], a["padding"],
                                   epilogue_tag=a["epilogue"])
            d = plan.decision
            (_, ksp) = sp.children
            (launch_sp,) = [c for c in ksp.children
                            if c.name == "kernels.launch"]
            assert launch_sp.attrs["route"] == d.route, a["layer"]
            xs = torch.empty(a["x_shape"], device="cuda")
            ws = torch.empty(ksp.attrs["w_shape"], device="cuda")
            res = (torch.empty((d.rows, d.cols), device="cuda")
                   if "residual" in a["epilogue"] else None)
            want = autotune.tile_util(d, autotune.launch_plan(d, xs, ws,
                                                              res))
            assert a["tile_util"] == ksp.attrs["tile_util"] == want, \
                a["layer"]
            assert a["effective_dataflow"] == plan.effective_dataflow.value
            tuned += a["tuned"]
        assert (tuned > 0) == (tuning and batch == 1)
    finally:
        autotune.reset()
        (autotune.enable if was else autotune.disable)()


# ------------------------------------------------------------ the record ---
def _main_path_convs() -> dict:
    """(x without its batch, w, stride, padding, epilogue) of every conv of
    the three 224x224 forwards, each with the nets that run it."""
    x = torch.randn((1, 224, 224, 3),
                    generator=torch.Generator().manual_seed(0))
    r50 = cnn.resnet50_init(torch.Generator().manual_seed(0), device="cpu")
    vgg = cnn.vgg16_init(torch.Generator().manual_seed(1), device="cpu")
    convs = {}
    for net, apply, params, kw in (
            ("resnet50", cnn.resnet50_apply, r50, {}),
            ("resnet50_sparse", cnn.resnet50_apply, r50, {"sparse": True}),
            ("vgg16", cnn.vgg16_apply, vgg, {})):
        with torch.no_grad(), trace.capture() as tr:
            apply(params, x, impl="ref", **kw)
        for sp in tr.find("carla_conv"):
            a = sp.attrs
            key = (tuple(a["x_shape"][1:]), tuple(a["w_shape"]), a["stride"],
                   a["padding"], a["epilogue"])
            convs.setdefault(key, set()).add(net)
    return convs


def record(path=PLANS_FILE, n_sms: int = 132) -> int:
    """Write the plans the code decides now, under the committed tables'
    entries, to ``path``; returns the number of cases."""
    entries = {}
    for table in sorted(Path(autotune.tables_dir()).glob("*.json")):
        entries.update({k: e["config"] for k, e in
                        json.loads(table.read_text())["entries"].items()})
    # the live cache holds those entries alone, not the tables' loader's
    os.environ["REPRO_TORCH_TUNED_TABLES_DIR"] = tempfile.mkdtemp()
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = tempfile.mkdtemp()
    real_vec, cases = _build.vec_path, []
    try:
        for (xs, ws, s, p, ep), nets in sorted(_main_path_convs().items()):
            for tuning in (False, True):
                autotune.reset()
                (autotune.enable if tuning else autotune.disable)()
                for key, cfg in entries.items() if tuning else ():
                    autotune.put(key, TileConfig.from_dict(cfg))
                for batch in (1, 16, 64):
                    for ok in (True, False):
                        _build.vec_path = (
                            lambda c, k, x, w, r, ok=ok: ok and c % 16 == 0
                            and k * x.element_size() % 16 == 0)
                        case = {"nets": sorted(nets), "x": [batch, *xs],
                                "w": list(ws), "stride": s, "padding": p,
                                "epilogue": ep, "vec_allowed": ok,
                                "tuning": tuning}
                        x, w = _operands(case)
                        d = autotune.decide(x.shape, w.shape, s, p,
                                            "float32", ep)
                        plan = autotune.launch_plan(d, x, w, n_sms=n_sms)
                        cases.append({**case, "entry": d.tiles and
                                      d.tiles.short, "route": d.route,
                                      "stationarity": d.stationarity and
                                      d.stationarity.value,
                                      "tile": plan.tile,
                                      "splits": plan.splits,
                                      "per": plan.per, "vec": plan.vec})
    finally:
        _build.vec_path = real_vec
        autotune.reset()
    head = json.dumps({"about": PLANS["about"], "n_sms": n_sms}, indent=1)
    body = ",\n".join(f"{json.dumps(k)}:{json.dumps(v, separators=(',', ':'))}"
                      for k, v in sorted(entries.items()))
    rows = ",\n".join(json.dumps(c, separators=(",", ":")) for c in cases)
    Path(path).write_text(f'{head[:-2]},\n "entries": {{\n{body}\n}},\n'
                          f' "cases": [\n{rows}\n]}}\n')
    return len(cases)


if __name__ == "__main__":
    print(record(), "cases written to", PLANS_FILE)
