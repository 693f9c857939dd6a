"""Seconds of set-up spent checking, building and loading the port's CUDA
libraries: the ``kernels.load`` spans of ``kernels/_build.py`` (a
library's first load in the process: hashing the sources, compiling any
that is not built, opening the shared library and declaring its entry
points), summed over the process."""
from portbench import hostspans

LAYER = "setup: kernels/_build.py"
MOVES = "setup_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
SCENARIOS = ("single_stream", "offline")


def read(r):
    return hostspans.setup_load_s(r)
