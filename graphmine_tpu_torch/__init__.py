"""graphmine_tpu_torch — the PyTorch/CUDA port of graphmine_tpu.

A package beside the JAX package (which stays the reference), with the
same module layout and names: ``io``, ``datasets``, ``graph``, ``ops``,
``pipeline``, ``obs``, ``serve``. It imports PyTorch, NumPy, SciPy and
pyarrow, never JAX and never ``graphmine_tpu``. Every entry point runs on
CUDA unless the caller passes another ``device`` (the CPU parity tests
pass ``device="cpu"``). The exact kNN of the LOF scorer runs a
hand-written CUDA kernel (``csrc/knn_topk.cu``) on CUDA tensors.
"""

from graphmine_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
