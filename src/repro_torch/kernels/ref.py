"""Plain PyTorch versions of the hand-written kernels (the ``ref.py`` contract).

af_gemm_ref, fx_gemm_ref, int8_gemm_ref and flash_attention_ref.

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
from ..accel.numerics import AdaptivFloatSpec, FixedPointSpec

AF83 = AdaptivFloatSpec(8, 3)


def int8_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a:(M,K) int8, b:(N,K) int8 -> (M,N) int32, exact. The product runs
    in float64, which every device multiplies (CUDA has no integer matmul):
    each |a·b| <= 2^14, so for K < 2^17 every partial sum is an integer
    below 2^31, exact in float64 in any order and in int32."""
    return (a.double() @ b.double().mT).to(torch.int32)


def fx_gemm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    x_spec: FixedPointSpec,
    w_spec: FixedPointSpec,
    o_spec: FixedPointSpec,
) -> torch.Tensor:
    """HLSCNN's fixed-point GEMM: ``FXq_o(FXq_x(x) @ FXq_w(w)^T)``.

    x: (M, K) or (B, M, K); w: (N, K) or (B, N, K). The quantized operands
    are integers on 2^-f grids, so every product and every sum of up to
    2^(53 - bx - bw + 2) of them is exact in float64, in any order: the sum
    is taken in float64, rounded once to float32, then quantized.
    """
    xq = numerics.fx_quantize(x, x_spec).double()
    wq = numerics.fx_quantize(w, w_spec).double()
    return numerics.fx_quantize((xq @ wq.mT).float(), o_spec)


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


#: the Pallas kernel's finite mask value (``repro/kernels/flash_attention.py``)
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The flash_attention kernel's function in plain ops: q (B, Hq, S, D),
    k and v (B, Hkv, Sk, D) -> (B, Hq, S, D) in q's dtype.

    fp32 throughout; KV heads repeated for GQA (query head h reads KV head
    h // (Hq // Hkv)); the causal mask ``q_idx >= k_idx`` aligned top-left;
    masked scores at the finite NEG_INF and an empty denominator set to 1,
    as in the Pallas kernel. Every key given is real (nothing is padded).
    """
    S, D = q.shape[2], q.shape[3]
    Sk, group = k.shape[2], q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = q.float() @ kf.mT * (1.0 / D ** 0.5)
    if causal:
        qi = torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(qi < ki, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    den = torch.where(den == 0, torch.ones_like(den), den)
    return ((p @ vf) / den).to(q.dtype)
