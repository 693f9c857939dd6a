"""CARLA core: the controller (``modes``), the analytic model (``cost_model``),
layer tables (``networks``), fused epilogues (``fuse``), structured sparsity
(``sparsity``) and the ``carla_conv`` dispatcher (``carla``).

Import from the submodules; this package file stays empty so that
``kernels`` can import ``core.modes`` without pulling in ``core.carla``.
"""
