"""The benchmark as data: ``BENCHMARK.json`` says what the files under
``portbench/`` say, keeps to the benchmark file's form, and a cell, a
configuration and a metric added as new files are found by name with no
file edited."""
import hashlib
import json
import re

import pytest

from portbench import harness, spec
from portbench.tests.conftest import write

BENCH = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_top_level_form():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT.parent / "BENCHMARK.json").read_bytes()) <= 65536


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        spec.check_name(e["name"], kind)
        if "unit" in e:
            spec.check_unit(e["unit"], e["name"])
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert ONE_LINE.fullmatch(e[key]), (e["name"], key)


def test_configs_are_their_files():
    for e in BENCH["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((spec.ROOT.parent / e["file"]).read_text())
        assert e["file"] == f"portbench/configs/{e['name']}.json"
        assert cfg["source"] == e["source"]
        assert cfg["reduced"] == e["reduced"]
        assert not any(k.endswith(("_dim", "_rank", "channels", "mid",
                                   "out")) for k in e["reduced"])
    assert {e["name"] for e in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}


def test_cells_are_their_files():
    assert sorted(w["name"] for w in BENCH["workloads"]) == \
        spec.names("workloads")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        c = spec.cell(w["name"])
        assert (c.config_name, c.traffic_name, c.chips, c.why) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert c.chips == 1
        assert set(c.limits) == {"logit_err"}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def _cells_of(e):
    return e.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_end_to_end_metrics_are_the_harness_s():
    # the harness reports each cell's end-to-end metrics as BENCHMARK.json
    # lists them
    cells = [w["name"] for w in BENCH["workloads"]]
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert set(_cells_of(e)) <= set(cells)
    for name in cells:
        assert spec.end_to_end(name) == {e["name"]: e["unit"]
                                         for e in BENCH["end_to_end"]
                                         if name in _cells_of(e)}
    assert "workloads" not in next(e for e in BENCH["end_to_end"]
                                   if e["name"] == "setup_s")


def test_per_layer_metrics_are_their_files():
    files = {m.name: m for m in spec.metrics()}
    assert sorted(files) == sorted(e["name"] for e in BENCH["per_layer"])
    for e in BENCH["per_layer"]:
        m = files[e["name"]]
        assert set(e) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (e["unit"], e["better"], e["source"], e["layer"],
                e["moves"]) == (m.unit, m.better, m.source, m.layer, m.moves)
        assert e["workloads"] == [w["name"] for w in BENCH["workloads"]
                                  if m.reports(spec.cell(w["name"]))]


def test_every_cell_reports_what_its_metrics_move():
    e2e = {e["name"]: set(_cells_of(e)) for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        name = w["name"]
        assert name in e2e["setup_s"]
        assert any(name in cells for k, cells in e2e.items()
                   if k != "setup_s")
        layer = [e for e in BENCH["per_layer"] if name in e["workloads"]]
        assert layer
        for e in layer:
            assert name in e2e[e["moves"]], (e["name"], name)
    for e in BENCH["per_layer"]:
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%"


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for e in BENCH["per_layer"]:
        layers.setdefault(e["layer"].split(":")[0], set()).add(e["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_found_with_no_file_edited(tiny_root):
    before = _digest(tiny_root)
    (tiny_root / "metrics" / "answers_per_window.py").write_text(
        'LAYER = "model: models/cnn.py"\nMOVES = "images_per_s"\n'
        'UNIT = "images"\nBETTER = "higher"\nSOURCE = "host_clock"\n'
        'SCENARIOS = ("offline",)\n\n\n'
        'def read(r):\n    return r.window.images\n')
    write(tiny_root, "traffic", "tiny_offline_b2",
          {"scenario": "offline", "batch": 2, "pool_images": 4,
           "warmup_forwards": 1, "profiled_forwards": 2})
    write(tiny_root, "workloads", "tiny_vgg16.tiny_offline_b2",
          {"config": "tiny_vgg16", "traffic": "tiny_offline_b2", "chips": 1,
           "why": "a throwaway cell", "limits": {"logit_err": 2e-5}})
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert "tiny_vgg16.tiny_offline_b2" in spec.names("workloads", tiny_root)
    assert "answers_per_window" in spec.names("metrics", tiny_root)
    r = harness.run_cell("tiny_vgg16.tiny_offline_b2", 11, 0.2, True,
                         device="cpu", root=tiny_root, log=lambda s: None)
    assert r["correct"]
    assert r["metrics"] == {"answers_per_window": {
        "value": r["attempted"], "unit": "images"}}


def test_a_name_outside_the_allowed_letters_is_refused(tiny_root):
    with pytest.raises(ValueError):
        spec.cell("../configs/resnet50", tiny_root)
    with pytest.raises(KeyError):
        spec.cell("no_such_cell", tiny_root)
