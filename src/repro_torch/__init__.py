"""CARLA on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` module for module (``core``, ``kernels``,
``models``, ``configs``, ``launch``, ``observability``) and keeps its
layouts at every public function: NHWC activations and HWIO weights for the
CNNs, (B, T, H, dh) queries and (B, S, Kh, dh) keys, values and caches for
the LMs.  The Pallas TPU kernels are replaced by CUDA C++
kernels for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
This package never imports JAX or ``repro``.
"""
