"""Plain PyTorch versions of the hand-written kernels (the ``ref.py`` contract).

af_gemm_ref, fx_gemm_ref, int8_gemm_ref and flash_attention_ref (with
bf16x3_split, the wgmma designs' split of P and of fp32 operands).

Each function computes what its kernel computes, in ordinary tensor ops: the
CPU runs it in place of the kernel, and tests and ``chip_smoke.py`` hold the
kernel against it on the card. Nothing on the main path calls it when a
card is present.

Argument order follows the kernel, ``(x, w, b, exp_bias_x, exp_bias_w,
exp_bias_o)``; the JAX reference ``repro.kernels.ref.af_gemm_ref`` takes the
weight bias first, so tests map the two by keyword.
"""
from __future__ import annotations

from typing import Optional

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


#: the reference's Pallas af_gemm sums K in blocks of this width
#: (``repro/kernels/ops.py`` pads every operand to its 128 defaults)
AF_BK = 128


def _fma_step(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``_flush(_fma(a, b, c))`` for float64 ``a`` and ``b`` holding float32
    values and float32 ``c``: one exactly rounded fused multiply-add,
    denormals flushed. The product is exact in float64 and the float64 sum
    ``s`` is rounded once, so ``s.float()`` rounds twice; that gives
    another float32 than the exact sum only where ``s`` lies halfway
    between two normal float32s. Where it does, and where the result is
    not 0 and at most 2^-126 (subnormal, or the normals' edge, whose
    rounding the subnormal grid decides), ``numerics._fma`` recomputes
    it; elsewhere ``s.float()`` is the answer."""
    s = torch.addcmul(c, a, b)
    r = s.float()
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    tiny = (r != 0) & (r.abs() <= numerics.MIN_NORMAL)
    redo = tie | tiny
    # the CPU skips a recomputation that changes nothing; the card does not
    # read back (a CUDA graph capture refuses it), so it always recomputes
    if r.device.type != "cpu" or bool(redo.any()):
        r = torch.where(redo, numerics._flush(numerics._fma(a, b, c)), r)
    return r


#: on the CPU the chain runs in pieces of at most this many outputs: torch
#: splits a larger op over its threads, and the chain's ops are many and
#: small, so that threads sharing the cores with other processes cost far
#: more than they save (six processes at once on an 8-core Xeon: 76 s a
#: call in whole ops, 1 s in pieces)
CPU_PIECE = 1 << 14


def af_block_sums(xq: torch.Tensor, wq: torch.Tensor, one_block: bool = False) -> torch.Tensor:
    """``xq @ wq^T`` summed as the reference's Pallas af_gemm sums it on
    the CPU: per block of :data:`AF_BK` k, from k = 0, ``acc = 0`` then
    ``acc = fma(xq[k], wq[k], acc)`` for k ascending (XLA's CPU dot at
    128 x 128 x 128 is that chain, bit for bit), each block's ``acc`` added
    into a float32 total that starts at 0, in order; denormals flushed to
    zeros of their sign at every step.

    ``one_block``: the kernel's grid is one block (one sample, M, N and K
    at most 128). XLA then unrolls the grid loop and simplifies ``0 + acc``
    to ``acc``, so a -0 sum (products flushed from tiny negatives) stays -0
    where a larger grid's total makes it +0.

    The reference pads K with zeros to a multiple of 128; a padded k adds
    fma(0, 0, acc), which is acc except that a -0 acc reads +0. So the last
    block stops at K and, where it is short of 128, adds +0 once. The chain
    runs one k at a time, vectorised over the outputs (:func:`_fma_step`;
    on the CPU over :data:`CPU_PIECE` of them at a time)."""
    xq, wq = xq.float(), wq.float()
    if xq.device.type == "cpu":
        rows = max(1, CPU_PIECE // (torch.broadcast_shapes(xq.shape[:-2], wq.shape[:-2]).numel()
                                    * wq.shape[-2]))
        if rows < xq.shape[-2]:
            return torch.cat([_chain(xq[..., i:i + rows, :], wq, one_block)
                              for i in range(0, xq.shape[-2], rows)], dim=-2)
    return _chain(xq, wq, one_block)


def _chain(xq: torch.Tensor, wq: torch.Tensor, one_block: bool) -> torch.Tensor:
    """:func:`af_block_sums` on float32 operands, all outputs at once."""
    x64, w64 = xq.double(), wq.double()
    K = xq.shape[-1]
    shape = torch.broadcast_shapes(xq.shape[:-2], wq.shape[:-2]) + (xq.shape[-2], wq.shape[-2])
    total = torch.zeros(shape, dtype=torch.float32, device=xq.device)
    for k0 in range(0, K, AF_BK):
        acc = torch.zeros_like(total)
        for k in range(k0, min(k0 + AF_BK, K)):
            acc = _fma_step(x64[..., :, k, None], w64[..., None, :, k], acc)
        if k0 + AF_BK > K:
            acc = acc + 0.0   # the padded k
        total = acc if one_block else numerics._flush(total + acc)
    return total


def af_gemm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    exp_bias_x,
    exp_bias_w,
    exp_bias_o,
    spec: AdaptivFloatSpec = AF83,
) -> torch.Tensor:
    """FlexASR LinearLayer semantics: AFq(AFq(x) @ AFq(w)^T + b), as the
    reference's Pallas ``af_gemm`` computes it (compiled: the quantizer's
    compiled form, :func:`af_block_sums`, then ``+ b`` in float32).

    x: (M, K) or (B, M, K); w: (N, K) or (B, N, K); b: (N,) or (B, N).
    Biases are numbers, 0-d tensors or per-sample ``(B,)`` tensors. A
    per-sample weight bias on a shared (N, K) weight quantizes one copy of
    the weight per sample, each with its sample's bias, as the kernel does.
    """
    if w.dim() == 2 and torch.as_tensor(exp_bias_w).dim() == 1:
        w = w.expand(len(exp_bias_w), *w.shape)
    one = max(x.shape[-2], w.shape[-2], x.shape[-1]) <= AF_BK and max(
        x.shape[:-2].numel(), w.shape[:-2].numel(), b.shape[:-1].numel()) == 1
    with numerics.tier("compiled"):
        xq = numerics.af_quantize(x, spec, exp_bias=_bias(exp_bias_x, x))
        wq = numerics.af_quantize(w, spec, exp_bias=_bias(exp_bias_w, w))
        # b read with denormals as zero, as XLA reads it
        y = numerics._flush(af_block_sums(xq, wq, one) + numerics._flush(b.float()).unsqueeze(-2))
        return numerics.af_quantize(y, spec, exp_bias=_bias(exp_bias_o, y))


#: the Pallas kernel's finite mask value (``repro/kernels/flash_attention.py``)
NEG_INF = -1e30


def bf16x3_split(p: torch.Tensor):
    """The wgmma design's split of fp32 ``p`` into three bf16 terms, each
    returned as an fp32 tensor holding bf16 values: ``hi = bf16(p)``,
    ``mid = bf16(p - hi)``, ``lo = bf16(p - hi - mid)`` (round to nearest
    even, the differences exact in fp32). ``hi + mid + lo == p`` exactly
    wherever p's lowest significant bit is on bf16's grid, which holds for
    every p >= 2^-110 (24 bits in three pieces of 8); below, lo is rounded
    to bf16's subnormal grid and the sum is within 2^-134 of p."""
    p = p.float()
    hi = p.bfloat16().float()
    mid = (p - hi).bfloat16().float()
    lo = (p - hi - mid).bfloat16().float()
    return hi, mid, lo


#: the pairs (i, j) of bf16 terms (hi, mid, lo = 0, 1, 2) whose products the
#: fp32 wgmma design sums: i + j <= 2. Each dropped pair (mid.lo, lo.mid,
#: lo.lo) weighs at most 2^-24 |a||b|, since |mid| <= 2^-8 |a| and
#: |lo| <= 2^-16 |a|.
TERM_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        pv_split: bool = False, split3: bool = False) -> torch.Tensor:
    """The flash_attention kernel's function in plain ops: q (B, Hq, S, D),
    k and v (B, Hkv, Sk, D) -> (B, Hq, S, D) in q's dtype.

    fp32 throughout; KV heads repeated for GQA (query head h reads KV head
    h // (Hq // Hkv)); scores scaled by ``scale`` (default 1/sqrt(D)); the
    causal mask ``q_idx >= k_idx`` aligned top-left; masked scores at the
    finite NEG_INF and an empty denominator set to 1, as in the Pallas
    kernel. Every key given is real (nothing is padded). ``pv_split`` takes
    P.V as the bf16 wgmma design does, the sum of the products of the three
    bf16 terms of P (:func:`bf16x3_split`) with V: the same function, summed
    in another order. ``split3`` takes both products as the fp32 design
    does: q, k, v and P each as three bf16 terms, Q.K^T and P.V each the
    sum of the products of the :data:`TERM_PAIRS` of terms.
    """
    S, D = q.shape[2], q.shape[3]
    Sk, group = k.shape[2], q.shape[1] // k.shape[1]
    scale = 1.0 / D ** 0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    if split3:
        qt, kt, vt = bf16x3_split(q), bf16x3_split(kf), bf16x3_split(vf)
        s = sum(qt[i] @ kt[j].mT for i, j in TERM_PAIRS) * scale
    else:
        s = q.float() @ kf.mT * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(qi < ki, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    den = torch.where(den == 0, torch.ones_like(den), den)
    if split3:
        pt = bf16x3_split(p)
        pv = sum(pt[i] @ vt[j] for i, j in TERM_PAIRS)
    elif pv_split:
        hi, mid, lo = bf16x3_split(p)
        pv = hi @ vf + mid @ vf + lo @ vf
    else:
        pv = p @ vf
    return (pv / den).to(q.dtype)
