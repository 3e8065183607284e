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

Every logarithm and power of two here is the reference's own (``repro``
on the CPU, where XLA compiles ``jnp.log``, ``jnp.exp`` and ``jnp.exp2``
into Cephes's polynomials as Eigen's ``plog_float`` / ``pexp_float`` write
them): ``log_f32``, ``exp_f32`` and ``exp2_ref`` repeat that algorithm step
by step in float32 tensor ops, so they give its bits on the CPU and on the
card alike. Three things of the compiled reference are part of it:

* the multiply-adds XLA's CPU backend contracts into fused multiply-adds
  (its object code has ``vfmadd`` exactly there) are fused here too, in
  float64 and rounded once to float32 (``_fma``, ``_fma_log``);
* XLA runs with denormals as zero: a subnormal input reads as a zero of
  its sign and a subnormal result is one (``_flush``);
* ``jnp.exp2(e)`` is ``exp(float32(ln 2) * e)``, exact only at some
  integers (-14, -12..12, 14, 16, ..., 28) and 0 at e <= -126, and
  ``jnp.log2(x)`` is ``log(x) * float32(1 / ln 2)`` (XLA compiles the
  division by the constant ln 2 into that multiply).

The reference has two tiers, and ``a / jnp.exp2(e)`` differs between them.
Run op by op (eager), it divides by ``exp2_ref(e)``. Compiled (``jax.jit``,
and every ``lax.switch``, whose branches XLA compiles as one computation
even when called op by op), XLA's algebraic simplifier rewrites
``A / exp(B)`` into ``A * exp(-B)``: a multiply by ``exp_f32(-(e * LN2))``.
:func:`div_exp2` computes the form of the tier set by :func:`tier`; the
default is the compiled one, which the reference's main path runs.

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import struct
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Bias = Union[float, torch.Tensor]


# --------------------------------------------------------------------------
# The reference's log, exp and exp2 (XLA on the CPU)
# --------------------------------------------------------------------------


def _f32(bits: int) -> float:
    """The float32 with these bits, as a Python float (exactly)."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


#: float32(1 / ln 2) (0x3fb8aa3b): the reference's log2 multiplies log(x) by
#: it, and it is Cephes's LOG2EF in exp
INV_LN2 = _f32(0x3fb8aa3b)
#: float32(ln 2) (0x3f317218): ``jnp.exp2(e)`` is ``exp(e * LN2)``
LN2 = _f32(0x3f317218)
#: the smallest normal float32, 2^-126
MIN_NORMAL = 2.0 ** -126

# Cephes's logf (Eigen's plog_float): mantissa in [sqrt(1/2), sqrt(2)) - 1,
# a degree-8 polynomial, ln 2 split into Q2 + Q1
_SQRTHF = _f32(0x3f3504f3)                    # 0.707106781186547524
_LOG_P = tuple(_f32(b) for b in (
    0x3d9021bb,   # p0  7.0376836292e-2
    0xbdebd1b8,   # p1 -1.1514610310e-1
    0x3def251a,   # p2  1.1676998740e-1
    0xbdfe5d4f,   # p3 -1.2420140846e-1
    0x3e11e9bf,   # p4  1.4249322787e-1
    0xbe2aae50,   # p5 -1.6668057665e-1
    0x3e4cceac,   # p6  2.0000714765e-1
    0xbe7ffffc,   # p7 -2.4999993993e-1
    0x3eaaaaaa,   # p8  3.3333331174e-1
))
_LN2_LO = _f32(0xb95e8083)                    # Q1 / C2 -2.12194440e-4
_LN2_HI = _f32(0x3f318000)                    # Q2 / C1  0.693359375

# Cephes's expf (Eigen's pexp_float): the input clamped as XLA clamps it,
# n = floor(x log2(e) + 1/2) in [-127, 127], x - n ln 2 in two parts, a
# degree-5 polynomial, times 2^n from the exponent bits
_EXP_LO, _EXP_HI = _f32(0xc2af999a), _f32(0x42b1999a)   # -87.8, 88.8
_EXP_P = tuple(_f32(b) for b in (
    0x39506967,   # p0 1.9875691500e-4
    0x3ab743ce,   # p1 1.3981999507e-3
    0x3c088908,   # p2 8.3334519073e-3
    0x3d2aa9c1,   # p3 4.1665795894e-2
    0x3e2aaaaa,   # p4 1.6666665459e-1
    0x3f000000,   # p5 0.5
))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, a fused multiply-add. The
    product of two float32s is exact in float64; the float64 sum is rounded
    to odd (its error, exact by TwoSum, sets the last bit), so that rounding
    it to float32 is the one correct rounding (53 >= 24 + 2 bits)."""
    p = a.double() * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.view(torch.int64)
    # an inexact even sum moves one float64 ulp toward the exact value
    step = ((err != 0) & ((bits & 1) == 0)).long() * torch.sign(err * s).long()
    return (bits + step).view(torch.float64).float()


def _fma_log(a: torch.Tensor, b, c) -> torch.Tensor:
    """``_fma`` without the round-to-odd step, for ``log_f32`` alone. The
    two differ only where the float64 sum lies halfway between two float32s
    and is inexact; the log's nine multiply-adds depend only on the
    mantissa and the exponent, and over every pair none does
    (``tests/exhaustive_log_fma.py``). A third of the ops: on an H100 the
    plain af_gemm of a fused group of 8 takes 0.675 ms with it, 1.394 ms
    with ``_fma``."""
    return (a.double() * b + c).float()


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Denormals as zero: a subnormal reads as a zero of its sign, as XLA's
    CPU code reads (and writes) it."""
    return torch.where(torch.abs(x) < MIN_NORMAL, x * 0.0, x)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` as XLA computes it on the CPU, bit for bit: 0 (or a
    subnormal) gives -inf, +inf gives +inf, a negative or NaN input NaN."""
    x = _flush(x.float())
    bits = torch.clamp(x, min=MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    # mantissa in [0.5, 1); below sqrt(1/2) it is doubled and e lowered
    m = ((bits & -2139095041) | 0x3f000000).view(torch.float32)
    low = m < _SQRTHF
    e = e - low.float()
    z = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z2 = z * z
    z3 = z2 * z
    y = _fma_log(z, _LOG_P[0], _LOG_P[1])
    y1 = _fma_log(z, _LOG_P[3], _LOG_P[4])
    y2 = _fma_log(z, _LOG_P[6], _LOG_P[7])
    y = _fma_log(y, z, _LOG_P[2])
    y1 = _fma_log(y1, z, _LOG_P[5])
    y2 = _fma_log(y2, z, _LOG_P[8])
    y = _fma_log(y, z3, y1)
    y = _fma_log(y, z3, y2)
    y = _fma_log(y, z3, e * _LN2_LO)
    # 0.5 z^2 and e Q2 are exact, so their fused forms round as these do
    r = (z - 0.5 * z2) + y
    r = r + e * _LN2_HI
    r = torch.where((x < 0) | torch.isnan(x), torch.full_like(r, float("nan")), r)
    r = torch.where(x == float("inf"), x, r)
    return torch.where(x == 0, torch.full_like(r, float("-inf")), r)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` as XLA computes it on the CPU, bit for bit: results
    below 2^-126 are 0, and inputs beyond [-87.8, 88.8] clamp there."""
    x = torch.clamp(x.float(), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, INV_LN2, 0.5)), -127.0, 127.0)
    # n C1 is exact, so its fused form rounds as this does
    r = x - n * _LN2_HI
    r = _fma(n, -_LN2_LO, r)
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma(y, r, p)
    y = _fma(y, r * r, r)
    y = y + 1.0
    # 2^n from the exponent bits (n = -127 gives the bits of 0)
    y = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(y)


def exp2_ref(e) -> torch.Tensor:
    """``jnp.exp2(e)`` as XLA computes it: ``exp_f32(e * LN2)``, the product
    rounded to float32. Not always the exact power: 0 at e <= -126, and an
    ulp or more off at most integers outside [-12, 12]."""
    return exp_f32(torch.as_tensor(e, dtype=torch.float32) * LN2)


#: the tables below cover every integer: exp_f32 clamps its input to
#: [-87.8, 88.8], so exp2_ref is constant below -127 and above 129, and
#: exp2_neg below -129 and above 127; one more entry, NaN, is their value
#: at NaN
_TABLE_LO, _TABLE_HI = -130, 130
_TABLES: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _int_table(name: str, fn, e: torch.Tensor) -> torch.Tensor:
    """``fn(e)`` for integer-valued ``e``, read from a table that ``fn``
    fills once per device: the same bits in a few tensor ops."""
    table = _TABLES.get((name, e.device))
    if table is None:
        table = fn(torch.arange(_TABLE_LO, _TABLE_HI + 1, dtype=torch.float32,
                                device=e.device))
        table = torch.cat([table, table.new_full((1,), float("nan"))])
        _TABLES[(name, e.device)] = table
    i = torch.nan_to_num(torch.clamp(e, _TABLE_LO, _TABLE_HI) - _TABLE_LO,
                         nan=table.numel() - 1)
    # take, not indexing: a 0-d index would read its value back to the host
    return torch.take(table, i.long())


def exp2_ref_int(e: torch.Tensor) -> torch.Tensor:
    """``exp2_ref(e)`` for integer-valued ``e`` (an exponent: AdaptivFloat's
    window, VecUnit's grid, VTA's shift), from a table."""
    return _int_table("exp2", exp2_ref, e)


def exp2_neg(e) -> torch.Tensor:
    """``exp(-B)`` for ``B = jnp.exp2``'s argument ``e * LN2``: what the
    compiled reference multiplies by where it divides by ``jnp.exp2(e)``.
    The product rounds to float32 before the negation, as in XLA."""
    return exp_f32(-(torch.as_tensor(e, dtype=torch.float32) * LN2))


def exp2_neg_int(e: torch.Tensor) -> torch.Tensor:
    """``exp2_neg(e)`` for integer-valued ``e``, from a table."""
    return _int_table("exp2_neg", exp2_neg, e)


#: True while the block runs in the reference's eager tier (:func:`tier`)
_EAGER = contextvars.ContextVar("repro_torch_numerics_eager", default=False)


@contextlib.contextmanager
def tier(name: str):
    """Run the block in the form of the reference's ``"eager"`` or
    ``"compiled"`` tier (:func:`div_exp2`). Compiled is the default: every
    instruction that quantizes (FlexASR's FN_START, VTA's ALU) has its
    reference body in a ``lax.switch``, compiled in every tier of the
    reference, ``simulate`` included. The eager form is set only where the
    reference quantizes outside any switch or ``jit``: the fused runners'
    weights and the Table-2 MaxPool case's input."""
    if name not in ("eager", "compiled"):
        raise ValueError(f"unknown tier {name!r}")
    token = _EAGER.set(name == "eager")
    try:
        yield
    finally:
        _EAGER.reset(token)


def div_exp2(a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The reference's ``a / jnp.exp2(e)`` for integer-valued ``e``, in the
    current tier's form, denormals flushed: eager divides by ``exp2_ref(e)``;
    compiled multiplies by ``exp2_neg(e)``. The two differ where the power
    is inexact and ``a`` is near a rounding boundary of the caller (an
    AdaptivFloat lattice midpoint, say), and where ``exp2_ref(e)`` is 0
    (e <= -126: eager divides by 0, compiled multiplies by a finite or
    infinite power)."""
    if _EAGER.get():
        return _flush(a / exp2_ref_int(e))
    return _flush(a * exp2_neg_int(e))


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """The reference's exponent ``floor(jnp.log2(x))``: ``floor(log_f32(x) *
    INV_LN2)``, the product rounded to float32."""
    return torch.floor(log_f32(x) * INV_LN2)


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


def af_exp_bias(x: torch.Tensor, spec: AdaptivFloatSpec) -> torch.Tensor:
    """Per-tensor exponent bias: align the max representable exponent with
    the tensor's max magnitude (AdaptivFloat Algorithm 1)."""
    return af_exp_biases([x], spec)[0]


def af_exp_biases(xs: Sequence[torch.Tensor], spec: AdaptivFloatSpec) -> torch.Tensor:
    """``af_exp_bias`` of each tensor (all on one device), stacked: one
    ``floor_log2`` for all of them, the same bits in a third of the tensor
    ops for three."""
    amax = _flush(torch.stack([torch.max(torch.abs(x.float())) for x in xs]))
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    return floor_log2(amax) - (2 ** spec.n_exp - 1)


def af_quantize(
    x: torch.Tensor, spec: AdaptivFloatSpec = AdaptivFloatSpec(), exp_bias: Optional[Bias] = None
) -> torch.Tensor:
    """Round ``x`` to the nearest AdaptivFloat-representable value, as the
    reference's ``af_quantize`` does, operation for operation, in the form
    of the current tier (:func:`tier`; its mantissa is :func:`div_exp2`).

    ``exp_bias`` is an integer, as a number or a tensor that broadcasts
    against ``x`` (a batch of per-sample biases shaped ``(B, 1, ...)``)."""
    if exp_bias is None:
        exp_bias = af_exp_bias(x, spec)
    xf = _flush(x.float())
    e_lo = torch.as_tensor(exp_bias, dtype=torch.float32, device=x.device)
    e_hi = e_lo + (2 ** spec.n_exp - 1)
    m = spec.n_man
    top = 2.0 - 2.0 ** (-m)
    # jnp.sign: +-0 and NaN are their own sign (torch.sign gives 0 for both)
    sign = torch.where(torch.abs(xf) > 0, torch.sign(xf), xf)
    ax = torch.abs(xf)
    # exponent of each value, clamped into the representable window
    safe = torch.where(ax > 0, ax, torch.ones_like(ax))
    e = torch.clamp(floor_log2(safe), e_lo, e_hi)
    # mantissa in [1, 2): round to m bits (ax / jnp.exp2(e) in the reference)
    man = torch.clamp(div_exp2(ax, e), 1.0, top)
    man_q = torch.round(man * 2.0 ** m) / 2.0 ** m
    # rounding can push mantissa to 2.0 -> bump exponent (saturating)
    bump = man_q >= 2.0
    e2 = torch.clamp(e + bump.float(), e_lo, e_hi)
    man_q = torch.where(bump & (e2 > e), torch.ones_like(man_q), torch.clamp(man_q, max=top))
    q = man_q * exp2_ref_int(e2)
    # saturate above the max normal; flush-to-zero below half the min normal
    vmax = top * exp2_ref_int(e_hi)
    vmin = exp2_ref_int(e_lo)
    q = torch.minimum(q, vmax)
    q = torch.where(ax < _flush(vmin * 0.5), torch.zeros_like(q), q)
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
