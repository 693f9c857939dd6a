"""The end-to-end benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell on the GPU and prints one JSON line last.
Everything a cell needs is found by name under this folder:

* ``workloads/<cell>.json``: the cell's configuration, traffic mix,
  chips, why it exists, and the limit of each number compared;
* ``configs/<name>.json``: a model's sizes at its published widths, with
  ``arch`` naming ``archs/<arch>.py`` (layer table, weights, the call into
  the port) and ``reference/<arch>.py`` (the plain fp32 forward);
* ``traffic/<name>.json``: the parameters the one loop in ``harness.py``
  reads (scenario, batch, pool of inputs, warm-up, profiled forwards);
* ``metrics/<name>.py``: one per-layer metric, its layer, the end-to-end
  metric it moves and its reader.

A later cell, configuration, traffic mix or metric is a new file here.
Nothing in this folder imports ``jax`` or the JAX package ``repro``, and
only ``archs/`` calls into ``repro_torch``.
"""
