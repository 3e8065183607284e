"""Public wrappers around the hand-written kernels.

The CUDA kernels mask ragged edges themselves, so nothing here pads (the
Pallas wrappers pad to block multiples instead).
"""
from __future__ import annotations

import torch

from ..accel import numerics
from ..accel.numerics import AdaptivFloatSpec
from .af_gemm import af_gemm


def af_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    spec: AdaptivFloatSpec = AdaptivFloatSpec(8, 3),
) -> torch.Tensor:
    """FlexASR linear-layer semantics through ``af_gemm``; auto exponent
    biases (the output window sized from the ideal fp32 product)."""
    bx = numerics.af_exp_bias(x, spec)
    bw = numerics.af_exp_bias(w, spec)
    ideal = x @ w.mT + b.unsqueeze(0)
    bo = numerics.af_exp_bias(ideal, spec)
    return af_gemm(x, w, b, bx, bw, bo, spec=spec)
