"""Public wrappers around the hand-written kernels.

The CUDA kernels mask ragged edges themselves, so nothing here pads (the
Pallas wrappers pad to block multiples instead). ``flash_attention`` needs
no more than its wrapper does, so this module re-exports the wrapper.
"""
from __future__ import annotations

import torch

from ..accel import numerics
from ..accel.numerics import AdaptivFloatSpec
from .af_gemm import af_gemm
from .flash_attention import flash_attention as flash_attention
from .fx_gemm import fx_gemm as _fx_gemm
from .int8_gemm import int8_gemm as _int8_gemm


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 @ (N,K)^T int8 -> (M,N) int32, arbitrary shapes."""
    return _int8_gemm(a.contiguous(), b.contiguous())


def fx_gemm(x: torch.Tensor, w: torch.Tensor, wgt_bits: int = 16) -> torch.Tensor:
    """HLSCNN's conv PE array on im2col patches: 16-bit activations and
    output (``HLSCNN_ACT``), 16- or 8-bit weights per CFG_DTYPE."""
    w_spec = numerics.HLSCNN_WEIGHT_UPDATED if wgt_bits >= 16 \
        else numerics.HLSCNN_WEIGHT_ORIGINAL
    return _fx_gemm(x.contiguous(), w.contiguous(), x_spec=numerics.HLSCNN_ACT,
                    w_spec=w_spec, o_spec=numerics.HLSCNN_ACT)


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
