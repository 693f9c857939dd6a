"""Runs of the harness on the CPU: sound runs come out correct, and each
fault an inference cell can have, planted underneath the harness in the
program, makes ``correct`` false; so does the TF32 control.  Runs start
no GPU look here (``run_cell`` on ``device="cpu"``), and nothing a run
imports loads JAX or the JAX package.
"""
import ast
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, spec

REPO = spec.ROOT.parent
CELLS = [f"tiny_{cfg}.{traffic}" for cfg in ("resnet50", "vgg16")
         for traffic in ("tiny_single", "tiny_offline")]


def run(root, cell, engine="program", trace=False, seed=2**31 + 5):
    return harness.run_cell(cell, seed, 0.2, trace, device="cpu", root=root,
                            engine=engine, log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["check"]["logit_err"]["value"] < 1e-6
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "check"]
    want = {"setup_s", "image_ms_p90"} if "single" in cell else {
        "setup_s", "images_per_s"}
    assert set(r["metrics"]) == want
    assert r["metrics"]["setup_s"]["unit"] == "s"


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(tiny_root, cell):
    r = run(tiny_root, cell, engine="reference_tf32")
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert r["check"]["logit_err"]["value"] > 3e-5


def _head_fault(monkeypatch, fault):
    """Patch the port's head, where the logits are produced."""
    from repro_torch.models import cnn
    head, calls = cnn._head, []

    def broken(x, w):
        y = head(x, w)
        calls.append(1)
        return fault(y, len(calls))
    monkeypatch.setattr(cnn, "_head", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(
        tiny_root, monkeypatch, cell):
    def alter(y, n):
        # one logit of the window's first answer (after one warm-up step),
        # by 1e-3 of its row: a window of any length holds it
        if n == 2:
            y = y.clone()
            y[0, 0] += 1e-3 * y[0].abs().max()
        return y
    _head_fault(monkeypatch, alter)
    r = run(tiny_root, cell)
    assert not r["correct"] and r["failed"] == 1


@pytest.mark.parametrize("cell", [c for c in CELLS if "offline" in c])
def test_half_of_the_batch_left_out_is_caught(tiny_root, monkeypatch, cell):
    def halve(y, n):         # the second half answered with the first's rows
        h = len(y) // 2
        return torch.cat([y[:h], y[:h]])
    _head_fault(monkeypatch, halve)
    r = run(tiny_root, cell)
    assert not r["correct"] and r["failed"] > 0


def test_an_answer_that_is_not_finite_is_caught(tiny_root, monkeypatch):
    _head_fault(monkeypatch, lambda y, n: y * torch.nan if n == 2 else y)
    r = run(tiny_root, "tiny_resnet50.tiny_single")
    assert not r["correct"] and r["check"]["logit_err"]["value"] == \
        float("inf")


@pytest.mark.parametrize("cell", ["tiny_resnet50.tiny_single",
                                  "tiny_vgg16.tiny_single"])
def test_the_traced_run_reads_the_host_metric_without_a_gpu(tiny_root, cell):
    # no device trace on the CPU: its readers return nothing, and only the
    # host's enqueue time is left
    r = run(tiny_root, cell, trace=True)
    assert r["correct"] and set(r["metrics"]) == {"enqueue_ms"}
    assert r["metrics"]["enqueue_ms"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_weights_and_inputs_repeat_from_the_seed(tiny_root, cell):
    c = spec.cell(cell, tiny_root)
    (pa, xa), (pb, xb) = (harness.draw(c, 2**31 + 7, torch.device("cpu"))
                          for _ in range(2))
    _, xc = harness.draw(c, 8, torch.device("cpu"))
    assert torch.equal(xa, xb) and not torch.equal(xa, xc)
    assert torch.equal(pa["fc"]["w"], pb["fc"]["w"])
    assert xa.shape == (c.traffic["pool_images"], 32, 32, 3)


def test_run_refuses_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    # a checkout of its own, so that the bytecode the run keeps lands there
    shutil.copytree(spec.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    (tmp_path / "src").symlink_to(REPO / "src")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "resnet50.single_stream", "--seed", "3000000000",
                        "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr
    assert list((tmp_path / "portbench" / ".bytecode").rglob("*.pyc"))


def test_run_refuses_without_the_port(tmp_path):
    shutil.copytree(spec.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "resnet50.single_stream", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr


def test_nothing_a_run_imports_loads_jax_or_repro():
    """Every module of the harness, every cell's program and reference and
    every metric, imported in a fresh interpreter as a run imports them."""
    code = f"""
import json, sys
sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
import portbench.run, portbench.readings
from portbench import harness, spec
import repro_torch.core.autotune
for name in spec.names("workloads"):
    c = spec.cell(name)
    c.arch().program(c.config)
    c.reference()
spec.metrics()
print(json.dumps(harness.forbidden_modules()))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((spec.ROOT / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
                if node.level:
                    continue
            else:
                continue
            assert set(tops) <= {"torch", "contextlib", "__future__"}, path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    found = harness.forbidden_modules()
    assert "repro.fake" in found and "repro_torch_fake" not in found


def test_answers_keep_every_step_in_order_past_their_reckoned_room():
    answers = harness.Answers(torch.zeros(2, 3), 3)
    for i in range(10):
        answers.next().fill_(i)
    got = answers.all()
    assert got.shape == (10, 2, 3) and answers.grown == 2
    assert got[:, 1, 2].tolist() == [float(i) for i in range(10)]
