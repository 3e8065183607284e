"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
their wrappers, and their plain PyTorch versions (``ref.py``).

af_gemm — FlexASR's AdaptivFloat linear layer (quantize-on-load fused)
"""
