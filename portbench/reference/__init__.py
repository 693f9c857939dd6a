"""Plain fp32 forwards that decide whether a run is correct.

Each ``<arch>.py`` works a network's forward out again, in plain PyTorch,
from the weights and inputs the harness made: no kernel, plan, cache or
helper of the program, and no import of ``repro_torch``, ``repro`` or
``jax``.  ``common.py`` holds the few operations they share.
"""
