"""The CUDA kernels (``conv2d``, ``matmul``), their plain PyTorch versions
(``ref``), the build (``_build``) and the instrumented dispatch (``ops``)."""
