"""Serve a reduced LM: batched prefill + greedy decode with a KV cache,
through the same step functions the decode dry-run cells trace.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        --arch zamba2-2.7b [--device cpu]

The port's ``examples/serve_lm.py``: ``launch.serve`` with ``--smoke``
(every other flag passes through).
"""
from __future__ import annotations

import sys

from ..launch.serve import main as serve_main


def main(argv=None):
    return serve_main(["--smoke"] + list(sys.argv[1:] if argv is None
                                         else argv))


if __name__ == "__main__":
    main()
