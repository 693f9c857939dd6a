"""Runnable examples, the port's counterparts of ``examples/``:

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart``, ``resnet50_carla`` and ``sparse_resnet`` (the CARLA
dispatcher, the CNN forwards and structured sparsity), ``serve_lm`` and
``train_lm`` (the launchers with ``--smoke``), ``train_e2e_medium`` (a
~20M-parameter model trained through the sharded step, the prefetching
pipeline and the checkpointing supervisor).  Each runs on the card unless
given ``--device cpu``, where the kernels' plain versions run.
"""
