"""CPU tests of the benchmark harness; ``test_portbench_chip.py`` runs on
the GPU only."""
