"""Plain PyTorch versions of the hand-written kernels (the ``ref.py`` contract).

Each function computes what its kernel computes, in ordinary tensor ops: the
CPU runs it in place of the kernel, and tests and ``chip_smoke.py`` hold the
kernel against it on the card. Nothing on the main path calls it when a
card is present.

Argument order follows the kernel, ``(x, w, b, exp_bias_x, exp_bias_w,
exp_bias_o)``; the JAX reference ``repro.kernels.ref.af_gemm_ref`` takes the
weight bias first, so tests map the two by keyword.
"""
from __future__ import annotations

import torch

from ..accel import numerics
from ..accel.numerics import AdaptivFloatSpec

AF83 = AdaptivFloatSpec(8, 3)


def _bias(v, like: torch.Tensor) -> torch.Tensor:
    """An exponent bias as a tensor broadcasting against ``like``: a number
    or 0-d tensor as is, a per-sample ``(B,)`` vector as ``(B, 1, 1)``."""
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if t.dim() == 1:
        t = t.reshape((-1,) + (1,) * (like.dim() - 1))
    return t


def af_gemm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    exp_bias_x,
    exp_bias_w,
    exp_bias_o,
    spec: AdaptivFloatSpec = AF83,
) -> torch.Tensor:
    """FlexASR LinearLayer semantics: AFq(AFq(x) @ AFq(w)^T + b).

    x: (M, K) or (B, M, K); w: (N, K) or (B, N, K); b: (N,) or (B, N).
    Biases are numbers, 0-d tensors or per-sample ``(B,)`` tensors.
    """
    xq = numerics.af_quantize(x, spec, exp_bias=_bias(exp_bias_x, x))
    wq = numerics.af_quantize(w, spec, exp_bias=_bias(exp_bias_w, w))
    y = xq @ wq.mT + b.unsqueeze(-2)
    return numerics.af_quantize(y, spec, exp_bias=_bias(exp_bias_o, y))
