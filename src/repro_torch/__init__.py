"""PyTorch/CUDA port of the D2A framework (``repro``), module for module.

The JAX package ``repro`` stays the reference; this package computes the same
functions with PyTorch tensors and runs on an NVIDIA GPU unless the caller
asks for the CPU (every entry point takes ``device``; ``None`` means
``"cuda"``). It imports ``torch``, ``numpy`` and the standard library only.

The TPU kernels of ``repro.kernels`` that the slice runs are hand-written CUDA
kernels here (``repro_torch/csrc``), each with a plain PyTorch version beside
it that the CPU runs.
"""

__version__ = "0.1.0"
