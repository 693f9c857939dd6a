"""The CUDA kernels (``conv2d``, ``matmul``, ``conv1d``, ``flash_attention``,
``decode_attention``), their plain PyTorch versions (``ref``), the build
(``_build``) and the instrumented dispatch (``ops``)."""
