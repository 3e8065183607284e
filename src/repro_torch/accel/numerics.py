"""Custom accelerator numerics, bit-accurate in PyTorch.

* **AdaptivFloat** (Tambe et al., DAC'20) — FlexASR's datatype: an n-bit
  float whose exponent range is shifted per-tensor by an integer bias chosen
  from the tensor's max magnitude. Quantization is exact: normalized
  mantissa rounded to m bits, exponent clamped to the 2^e window, values
  below the smallest normal flushed to zero, saturation at the top.

* **Fixed point** — HLSCNN's 8/16-bit two's-complement fixed point with a
  static number of fraction bits.

* **int8 symmetric** — VTA's integer GEMM path (scale = amax/127).

All quantizers are ``quantize -> dequantize`` (fake-quant), so downstream
compute runs in fp32 on the accelerator's representable set.

Two choices keep these bit-identical to the JAX reference (``repro``):

* the exponent is ``floor(log(x) / ln 2)``, the reference's own definition
  of ``log2`` (``jnp.log2`` is ``log(x) / log(2)``), not an exact exponent:
  just below a power of two the rounded quotient lands on the power itself,
  and the two definitions then pick different binades;
* ``2^e`` is built exactly from the exponent bits (the CUDA kernel uses
  ``ldexpf``), never through ``exp2``.

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

Bias = Union[float, torch.Tensor]

#: ln 2 in float32 (0x3f317218); the CUDA kernel divides by the same constant
LN2 = 0.6931471805599453


# --------------------------------------------------------------------------
# AdaptivFloat
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdaptivFloatSpec:
    n_bits: int = 8
    n_exp: int = 3  # exponent field width; mantissa = n_bits - 1 - n_exp

    @property
    def n_man(self) -> int:
        return self.n_bits - 1 - self.n_exp


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """``floor(log(x) / ln 2)`` in float32, the reference's exponent."""
    ln2 = torch.full((), LN2, dtype=torch.float32, device=x.device)
    return torch.floor(torch.log(x) / ln2)


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2^e`` for integer-valued float ``e`` (down to 2^-149),
    assembled from exponent bits: two factors so subnormals stay exact."""
    ei = e.to(torch.int32)
    e1 = ei.clamp(-126, 127)
    e2 = (ei - e1).clamp(-126, 0)
    return ((e1 + 127) << 23).view(torch.float32) * ((e2 + 127) << 23).view(torch.float32)


def af_exp_bias(x: torch.Tensor, spec: AdaptivFloatSpec) -> torch.Tensor:
    """Per-tensor exponent bias: align the max representable exponent with
    the tensor's max magnitude (AdaptivFloat Algorithm 1)."""
    amax = torch.max(torch.abs(x.float()))
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    return floor_log2(amax) - (2 ** spec.n_exp - 1)


def af_quantize(
    x: torch.Tensor, spec: AdaptivFloatSpec = AdaptivFloatSpec(), exp_bias: Optional[Bias] = None
) -> torch.Tensor:
    """Round ``x`` to the nearest AdaptivFloat-representable value.

    ``exp_bias`` is a number or a tensor that broadcasts against ``x`` (a
    batch of per-sample biases shaped ``(B, 1, ...)``)."""
    if exp_bias is None:
        exp_bias = af_exp_bias(x, spec)
    xf = x.float()
    e_lo = torch.as_tensor(exp_bias, dtype=torch.float32, device=x.device)
    e_hi = e_lo + (2 ** spec.n_exp - 1)
    m = spec.n_man
    top = 2.0 - 2.0 ** (-m)
    sign = torch.sign(xf)
    ax = torch.abs(xf)
    # exponent of each value, clamped into the representable window
    safe = torch.where(ax > 0, ax, torch.ones_like(ax))
    e = torch.clamp(floor_log2(safe), e_lo, e_hi)
    scale = exp2_int(e)
    # mantissa in [1, 2): round to m bits
    man = torch.clamp(ax / scale, 1.0, top)
    man_q = torch.round(man * 2.0 ** m) / 2.0 ** m
    # rounding can push mantissa to 2.0 -> bump exponent (saturating)
    bump = man_q >= 2.0
    e2 = torch.clamp(e + bump.float(), e_lo, e_hi)
    man_q = torch.where(bump & (e2 > e), torch.ones_like(man_q), torch.clamp(man_q, max=top))
    q = man_q * exp2_int(e2)
    # saturate above the max normal; flush-to-zero below half the min normal
    vmax = top * exp2_int(e_hi)
    vmin = exp2_int(e_lo)
    q = torch.minimum(q, vmax)
    q = torch.where(ax < vmin * 0.5, torch.zeros_like(q), q)
    return (sign * q).to(x.dtype)


def af_ste(x: torch.Tensor, spec: AdaptivFloatSpec = AdaptivFloatSpec()) -> torch.Tensor:
    """Straight-through-estimator fake quant (identity gradient)."""
    return x + (af_quantize(x, spec) - x).detach()


# --------------------------------------------------------------------------
# Fixed point
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FixedPointSpec:
    n_bits: int = 8
    n_frac: int = 6

    @property
    def scale(self) -> float:
        return float(2 ** self.n_frac)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.n_bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.n_bits - 1) - 1


# HLSCNN's original 8-bit weights keep a 2^-3 grid over +/-16; the
# developers' 16-bit update keeps the range with a 2^-11 grid.
HLSCNN_WEIGHT_ORIGINAL = FixedPointSpec(n_bits=8, n_frac=3)
HLSCNN_WEIGHT_UPDATED = FixedPointSpec(n_bits=16, n_frac=11)
HLSCNN_ACT = FixedPointSpec(n_bits=16, n_frac=8)


def fx_quantize_int(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """To the integer (two's complement) representation."""
    q = torch.round(x.float() * spec.scale)
    return torch.clamp(q, spec.qmin, spec.qmax).to(torch.int32)


def fx_dequantize(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return q.to(torch.float32) / spec.scale


def fx_quantize(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Fake quant: round to the fixed-point lattice."""
    return fx_dequantize(fx_quantize_int(x, spec), spec)


# --------------------------------------------------------------------------
# int8 symmetric (VTA)
# --------------------------------------------------------------------------


def int8_scale(x: torch.Tensor) -> torch.Tensor:
    amax = torch.max(torch.abs(x.float()))
    return torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)


def int8_quantize(x: torch.Tensor, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if scale is None:
        scale = int8_scale(x)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


# --------------------------------------------------------------------------
# Saturation points and rounding grids
# --------------------------------------------------------------------------

# Block-scaled formats (AdaptivFloat, block-fp) renormalize per tensor, so
# their absolute overflow point depends on the data, not the spec. 4.5 is
# the modeling constant for the rare-overflow tail of unit-scale
# activations: values beyond it fall outside the window a per-block
# exponent chosen for |x| <~ 1 data can still represent.
BLOCK_SCALED_SAT = 4.5


def fixed_saturation(spec: FixedPointSpec) -> float:
    """Largest representable magnitude (up to one LSB) of a fixed-point
    format: 2^(integer bits)."""
    return float(2.0 ** (spec.n_bits - 1 - spec.n_frac))


def saturation_point(numerics: str) -> float:
    """Absolute saturation/wrap threshold for a target's declared numerics
    string (``AcceleratorTarget.capabilities["numerics"]``)."""
    if numerics.startswith(("fixed", "int8")):
        return fixed_saturation(HLSCNN_ACT)
    return BLOCK_SCALED_SAT


def rounding_grid(numerics: str) -> Optional[float]:
    """Quantization grid spacing near zero for a numerics family, or None
    when the family has no static grid (pure-integer paths rescale
    per-tensor, so a fixed grid is meaningless)."""
    if numerics.startswith("int8"):
        return None
    if numerics.startswith("fixed"):
        return 1.0 / HLSCNN_ACT.scale
    # block-scaled: one mantissa step below the unit binade
    return float(2.0 ** -(AdaptivFloatSpec().n_man + 1))
