"""Hand-written CUDA kernels of the port, each with its ctypes wrapper.

Each wrapper module builds its source from ``graphmine_tpu_torch/csrc``
with ``nvcc`` at first use.
"""
