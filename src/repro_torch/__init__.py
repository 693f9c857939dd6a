"""CARLA on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` module for module (``core``, ``kernels``,
``models``, ``observability``); activations are NHWC and weights HWIO at
every public function.  The Pallas TPU kernels are replaced by CUDA C++
kernels for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
This package never imports JAX or ``repro``.
"""
