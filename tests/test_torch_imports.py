"""The port stands alone: no JAX, no ``repro``, and CUDA entry points that
refuse to fall back to the CPU quietly."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert not _imported_roots(path) & FORBIDDEN


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.models.cnn, "
            "repro_torch.kernels.ops, repro_torch.core.carla, "
            "repro_torch.models.convert, repro_torch.models.lm, "
            "repro_torch.launch.serve, repro_torch.configs.zamba2_2_7b; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=300)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import cnn, lm
    from repro_torch.models.convert import (
        lm_params_from_numpy,
        params_from_numpy,
    )
    cfg = get_config("zamba2-2.7b", smoke=True)
    lm_tree = {"embed": {}, "final_norm": {}, "blocks": {}}
    for call in (cnn.resnet50_init, cnn.vgg16_init,
                 lambda: params_from_numpy({}),
                 lambda: lm.init_params(cfg),
                 lambda: lm.init_cache(cfg, 1, 8),
                 lambda: lm_params_from_numpy(lm_tree),
                 lambda: serve.load_model("zamba2-2.7b", smoke=True),
                 lambda: serve.make_prompts(cfg, 1, 8),
                 lambda: serve.main(["--arch", "zamba2-2.7b", "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
