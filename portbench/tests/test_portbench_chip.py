"""On the GPU, at each cell's own size: the program is correct and its
control, the plain reference with TF32 on put in the program's place, is
not, on three seeds each.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -q portbench/tests/test_portbench_chip.py
"""
import pytest

from portbench import harness, spec

SEEDS = (3_000_000_101, 3_000_000_202, 3_000_000_303)


@pytest.mark.chip
@pytest.mark.parametrize("engine,correct", [("program", True),
                                            ("reference_tf32", False)])
@pytest.mark.parametrize("cell", spec.names("workloads"))
def test_control_fails_where_the_program_passes(cuda, cell, engine, correct):
    for seed in SEEDS:
        r = harness.run_cell(cell, seed, 1.0, False, engine=engine,
                             log=lambda s: None)
        assert r["correct"] is correct, (cell, engine, seed, r["check"])
