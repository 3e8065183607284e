"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
their wrappers, and their plain PyTorch versions (``ref.py``).

af_gemm   — FlexASR's AdaptivFloat linear layer (quantize-on-load fused)
fx_gemm   — HLSCNN's fixed-point conv as an im2col GEMM (exact float64 sums)
int8_gemm — VTA's int8 x int8 -> int32 GEMM
flash_attention — online-softmax attention with GQA (the LM serving path)
"""
