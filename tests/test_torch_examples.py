"""The port's examples (``repro_torch.examples``), each run as a user runs
it, on the CPU at smoke size, and each refusing to run without a card
unless asked for the CPU."""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# (module, arguments after --device cpu, text its output must hold)
EXAMPLES = [
    ("quickstart", [], "ResNet-50 on CARLA: 92.8 ms"),
    ("resnet50_carla", [], "TOTAL: 92.8 ms"),
    ("sparse_resnet", [], "prepruned matches: True"),
    ("serve_lm", ["--arch", "zamba2-2.7b", "--gen", "4"], "decoded 4 tokens"),
    ("train_lm", ["--arch", "smollm-135m", "--steps", "3"], "done at step 3"),
    ("train_e2e_medium", ["--smoke", "--steps", "3"], "3 steps in"),
]


@pytest.mark.parametrize("name,args,want", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_the_cpu(name, args, want, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                          "--device", "cpu", *args], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert want in res.stdout, res.stdout[-3000:]


@pytest.mark.parametrize("name", [e[0] for e in EXAMPLES])
def test_example_defaults_to_the_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    args = {"serve_lm": ["--arch", "zamba2-2.7b"],
            "train_lm": ["--arch", "smollm-135m", "--steps", "1"]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args.get(name, []))
