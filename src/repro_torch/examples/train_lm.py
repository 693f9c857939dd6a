"""Train a reduced LM end to end with the full substrate: the train step,
the prefetching data pipeline, the checkpointing supervisor.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        --arch gemma2-9b --steps 30 [--device cpu]

The port's ``examples/train_lm.py``: ``launch.train`` with ``--smoke
--steps 30`` and a checkpoint directory under the temporary directory
(every flag given passes through and wins).  Any of the ten archs works.
"""
from __future__ import annotations

import os
import sys
import tempfile

from ..launch.train import main as train_main


def main(argv=None):
    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt")
    return train_main(["--smoke", "--steps", "30", "--ckpt-dir", ckpt]
                      + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
