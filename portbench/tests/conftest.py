"""Fixtures of the harness's tests: a copy of the benchmark's folder with
tiny cells (published structure, narrow widths, 32 x 32 images) that run on
the CPU in a fraction of a second, and the look for a GPU."""
import json
import shutil

import pytest
import torch

from portbench import spec

TINY_WIDTHS = {"resnet50": [(4, 16), (8, 16), (8, 32), (8, 32)],
               "vgg16": [4, 8, 8, 16, 16]}
TINY_TRAFFIC = {
    "tiny_single": {"scenario": "single_stream", "batch": 1, "pool_images": 4,
                    "warmup_forwards": 1, "profiled_forwards": 3},
    "tiny_offline": {"scenario": "offline", "batch": 4, "pool_images": 8,
                     "warmup_forwards": 1, "profiled_forwards": 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


def tiny_config(name: str) -> dict:
    """The configuration at its published structure, narrowed."""
    cfg = json.loads((spec.ROOT / "configs" / f"{name}.json").read_text())
    cfg.update(image_size=32, num_classes=10)
    if name == "resnet50":
        cfg["stem_channels"] = 8
        for g, (mid, out) in zip(cfg["groups"], TINY_WIDTHS[name]):
            g.update(mid=mid, out=out)
    else:
        for g, c in zip(cfg["groups"], TINY_WIDTHS[name]):
            g["channels"] = c
    return cfg


def write(root, kind: str, name: str, obj: dict) -> None:
    (root / kind / f"{name}.json").write_text(json.dumps(obj))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of portbench/ with cells ``tiny_<config>.<traffic>`` (limit
    2e-5, as the full-size cells), and beside it a copy of BENCHMARK.json
    in which each tiny cell reports the end-to-end metrics of the cells of
    its scenario."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
    for e in bench["end_to_end"]:
        if "workloads" in e:
            scenarios = {spec.cell(w).scenario for w in e["workloads"]}
            e["workloads"] += [f"tiny_{cfg}.{name}" for cfg in TINY_WIDTHS
                               for name, traffic in TINY_TRAFFIC.items()
                               if traffic["scenario"] in scenarios]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for cfg in TINY_WIDTHS:
        write(root, "configs", f"tiny_{cfg}", tiny_config(cfg))
    for name, traffic in TINY_TRAFFIC.items():
        write(root, "traffic", name, traffic)
        for cfg in TINY_WIDTHS:
            write(root, "workloads", f"tiny_{cfg}.{name}",
                  {"config": f"tiny_{cfg}", "traffic": name, "chips": 1,
                   "why": "a CPU test", "limits": {"logit_err": 2e-5}})
    return root


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
