"""PyTorch port: the arithmetic arguments behind the af_gemm and fx_gemm kernels.

The CUDA kernels (``csrc/af_gemm.cu``, ``csrc/fx_gemm.cu``) run only on the
card; these tests hold, on the CPU, the two claims that make them equal
their plain versions bit for bit:

* af_gemm's quantizer multiplies by powers of two built from exponent bits
  where the plain version divides by them or calls ``ldexpf``. Written here
  in torch exactly as the kernel writes it, it equals
  ``accel/numerics.py::af_quantize`` bitwise on 2^20 float32 inputs spread
  over every bias of the kernel's fast window range ([-126, 119] at
  n_exp = 3; other windows take the kernel's wide quantizer, which divides
  as the plain version does), and on the boundary
  set of ``tests/test_torch_numerics.py`` (powers of two and the floats just
  below them, lattice midpoints, vmin/2, the saturation edge, 4.5). The
  kernel keeps its scratch in fp32, so no bf16 round trip is involved.
* fx_gemm splits each 16-bit lattice integer into a signed high byte and
  an unsigned low byte, multiplies the bytes on the int8 tensor cores with
  int32 sums, and splits K into eight slices whose float64 partial sums are
  combined in shared memory. At the worst-case magnitudes
  (every operand at qmin or qmax) up to the largest K that ``check_exact``
  admits, every partial and every order of combining them gives the exact
  integer sum, and the result equals ``fx_gemm_ref``.
"""
import numpy as np
import pytest
import torch

from repro_torch.accel import numerics as tn
from repro_torch.kernels import fx_gemm as kfx, ref

SPEC = tn.AdaptivFloatSpec(8, 3)
#: the biases whose whole window keeps 2^e and 2^-e normal (csrc/af_gemm.cu)
FAST_BIASES = range(-126, 126 - (2 ** SPEC.n_exp - 1) + 1)


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2^n for int32 n in [-126, 127], from the exponent bits (``pow2i``)."""
    return ((n + 127) << 23).view(torch.float32)


def _af_quant_fast(x: torch.Tensor, e_lo: torch.Tensor) -> torch.Tensor:
    """``af_quant_fast`` of csrc/af_gemm.cu, operation for operation."""
    m = SPEC.n_man
    e_hi = e_lo + (2 ** SPEC.n_exp - 1)
    top = torch.tensor(2.0 - 2.0 ** -m)
    p, inv_p = 2.0 ** m, 2.0 ** -m
    # the window's constants come from ldexpf (exp2_int: the same exact powers)
    vmax = top * tn.exp2_int(e_hi)
    flush = tn.exp2_int(e_lo) * 0.5
    one = torch.ones_like(x)
    sign = torch.where(x > 0, one, torch.where(x < 0, -one, torch.zeros_like(x)))
    ax = x.abs()
    safe = torch.where(ax > 0, ax, torch.ones_like(ax))
    e = torch.clamp(tn.floor_log2(safe), e_lo, e_hi)
    man = torch.clamp(ax * _pow2(-e.int()), torch.tensor(1.0), top)
    man_q = torch.round(man * p) * inv_p
    bump = man_q >= 2.0
    e2 = torch.clamp(e + bump.float(), e_lo, e_hi)
    man_q = torch.where(bump & (e2 > e), torch.ones_like(man_q), torch.minimum(man_q, top))
    q = torch.minimum(man_q * _pow2(e2.int()), vmax)
    q = torch.where(ax < flush, torch.zeros_like(q), q)
    return sign * q


def _random_inputs(n_per_bias: int, seed: int = 0):
    """float32 values whose binades cover each fast bias's window, three
    binades below it (flush) and two above (saturation), random mantissas
    and signs; returned with each value's bias."""
    rng = np.random.default_rng(seed)
    biases = np.repeat(np.asarray(FAST_BIASES, np.int64), n_per_bias)
    width = 2 ** SPEC.n_exp
    e = biases + rng.integers(-3, width + 2, biases.size)
    biased = np.clip(e + 127, 0, 254).astype(np.uint32)
    mant = rng.integers(0, 2 ** 23, biases.size, dtype=np.uint32)
    sign = rng.integers(0, 2, biases.size, dtype=np.uint32) << 31
    x = (sign | (biased << 23) | mant).view(np.float32)
    return torch.from_numpy(x), torch.from_numpy(biases.astype(np.float32))


def _boundary_inputs(bias: float) -> np.ndarray:
    """tests/test_torch_numerics.py's boundary set, at any bias."""
    m = SPEC.n_man
    e_lo, e_hi = bias, bias + 2 ** SPEC.n_exp - 1
    vals = [0.0, 4.5, -4.5]
    for k in list(range(-12, 13)) + list(range(int(e_lo) - 2, int(e_hi) + 3)):
        if not -149 <= k <= 127:
            continue
        p = np.float32(2.0 ** k)
        below = np.nextafter(p, np.float32(0))
        vals += [p, below, np.nextafter(below, np.float32(0)), np.nextafter(p, np.float32(1e38))]
    for e in range(int(e_lo), int(e_hi) + 1):
        steps = np.arange(2 ** m, 2 ** (m + 1)) + 0.5
        vals += list(steps * 2.0 ** (e - m))
    vmax = (2 - 2.0 ** -m) * 2.0 ** e_hi
    vmin = 2.0 ** e_lo
    for v in (vmax, vmin / 2, vmin):
        f = np.float32(v)
        vals += [f, np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(1e38))]
    x = np.asarray(vals, np.float32)
    return np.concatenate([x, -x])


def test_fast_window_range_keeps_powers_normal():
    for bias in FAST_BIASES:
        for e in range(bias, bias + 2 ** SPEC.n_exp):
            assert -126 <= e <= 127 and -126 <= -e <= 127
    assert min(FAST_BIASES) == -126 and max(FAST_BIASES) == 119


def test_af_fast_quantizer_bit_exact_on_2_20_random_inputs():
    x, bias = _random_inputs(-(-2 ** 20 // len(FAST_BIASES)))
    assert x.numel() >= 2 ** 20 and bool(torch.isfinite(x).all())
    want = tn.af_quantize(x, SPEC, exp_bias=bias)
    got = _af_quant_fast(x, bias)
    bad = torch.nonzero(got.view(torch.int32) != want.view(torch.int32)).flatten()
    assert bad.numel() == 0, list(zip(x[bad][:8].tolist(), bias[bad][:8].tolist(),
                                     got[bad][:8].tolist(), want[bad][:8].tolist()))


@pytest.mark.parametrize("bias", [-126.0, -100.0, -10.0, -7.0, -5.0, -3.0, 0.0, 2.0, 60.0,
                                  119.0])
def test_af_fast_quantizer_bit_exact_on_boundaries(bias):
    x = torch.from_numpy(_boundary_inputs(bias))
    e_lo = torch.full_like(x, bias)
    want = tn.af_quantize(x, SPEC, exp_bias=e_lo)
    got = _af_quant_fast(x, e_lo)
    bad = torch.nonzero(got.view(torch.int32) != want.view(torch.int32)).flatten()
    assert bad.numel() == 0, list(zip(x[bad][:8].tolist(), got[bad][:8].tolist(),
                                     want[bad][:8].tolist()))


#: fx_gemm's K slices (csrc/fx_gemm.cu: SPLIT blocks, slices rounded up to 4)
#: and the chunks between moves of its int32 sums into float64
SPLIT, FLUSH = 8, 512


def test_fx_byte_split_exact_over_16_bits():
    """Every 16-bit lattice integer is 256 * (signed high byte) + (unsigned
    low byte), the operands of the kernel's int8 mma, and FLUSH chunks of
    32 byte products stay below 2^31."""
    q = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32)
    hi, lo = q >> 8, q & 255
    assert int(hi.min()) == -128 and int(hi.max()) == 127
    assert int(lo.min()) == 0 and int(lo.max()) == 255
    assert torch.equal(256 * hi + lo, q)
    assert FLUSH * 32 * 255 * 255 < 2 ** 31 and FLUSH * 32 * 128 * 255 < 2 ** 31
    assert kfx.MAX_BITS == 16


def _slices(K: int):
    size = (-(-K // SPLIT) + 3) // 4 * 4
    return [(s * size, min(K, (s + 1) * size)) for s in range(SPLIT)]


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("M,N,K,pattern", [
    (4, 3, 800, "mixed"), (2, 2, 800, "qmin"), (3, 2, 801, "mixed"), (2, 3, 4096, "qmax"),
    (1, 1, 2 ** 23 - 1, "qmin"),
])
def test_fx_split_k_partials_exact_in_any_order(M, N, K, pattern, bits):
    x_spec = tn.HLSCNN_ACT
    w_spec = tn.HLSCNN_WEIGHT_UPDATED if bits == 16 else tn.HLSCNN_WEIGHT_ORIGINAL
    kfx.check_exact(K, x_spec, w_spec)  # admitted: the largest K case is at the edge
    if K == 2 ** 23 - 1 and bits == 16:
        with pytest.raises(ValueError, match="exact"):
            kfx.check_exact(K + 1, x_spec, w_spec)
    rng = np.random.default_rng(K + bits)

    def extreme(shape, spec):
        if pattern == "mixed":
            ints = rng.choice([spec.qmin, spec.qmax], size=shape)
        else:
            ints = np.full(shape, spec.qmin if pattern == "qmin" else spec.qmax)
        # scaled past the range: the quantizer clamps to qmin / qmax
        return torch.from_numpy((ints * 1.5 / spec.scale).astype(np.float32))

    x, w = extreme((M, K), x_spec), extreme((N, K), w_spec)
    xi = tn.fx_quantize_int(x, x_spec).long()
    wi = tn.fx_quantize_int(w, w_spec).long()
    assert set(xi.unique().tolist()) <= {x_spec.qmin, x_spec.qmax}
    exact = (xi[:, None, :] * wi[None, :, :]).sum(-1)           # int64, exact
    # each slice as the kernel sums it: byte planes, int32 sums of 32-deep
    # chunks moved into float64, 65536 hh + 256 (hl + lh) + ll
    xh, xl, wh, wl = xi >> 8, xi & 255, wi >> 8, wi & 255
    partials = []
    for a, b in _slices(K):
        pad = -(b - a) % 32

        def chunks(t):  # (rows, chunks, 32), zero past the slice's end
            return torch.nn.functional.pad(t[:, a:b], (0, pad)).reshape(t.shape[0], -1, 32)

        planes = [torch.einsum("mck,nck->mnc", chunks(p), chunks(q))
                  for p, q in ((xh, wh), (xh, wl), (xl, wh), (xl, wl))]
        assert all(int(t.abs().max()) < 2 ** 31 // FLUSH for t in planes)
        hh, hl, lh, ll = (t.double() for t in planes)
        acc = (65536.0 * hh + 256.0 * hl + 256.0 * lh + ll).sum(-1)
        partials.append(acc)
        assert torch.equal(acc, (xi[:, None, a:b] * wi[None, :, a:b]).sum(-1).double())
    want = ref.fx_gemm_ref(x, w, x_spec, w_spec, x_spec)
    inv_xw = 2.0 ** -(x_spec.n_frac + w_spec.n_frac)
    for order in [list(range(SPLIT)), list(range(SPLIT))[::-1]] + \
            [list(rng.permutation(SPLIT)) for _ in range(4)]:
        total = torch.zeros_like(partials[0])
        for s in order:
            total = total + partials[s]
        assert torch.equal(total, exact.double())
        got = tn.fx_quantize((total * inv_xw).float(), x_spec)
        assert torch.equal(got, want)
