"""PyTorch port: the arithmetic arguments behind the af_gemm and fx_gemm kernels.

The CUDA kernels (``csrc/af_gemm.cu``, ``csrc/fx_gemm.cu``) run only on the
card; these tests hold, on the CPU, the two claims that make them equal
their plain versions bit for bit:

* af_gemm's quantizer reads each power of two from a table of its
  window's 2^n_exp powers, ``exp2_ref(e_lo + i)``, and of what the compiled
  reference multiplies by in their place, ``exp2_neg(e_lo + i)``, filled
  once per block, where the plain version reads ``exp2_ref_int``'s and
  ``exp2_neg_int``'s tables, and multiplies the magnitude by the second as
  the plain version's compiled form does. Written here in torch exactly
  as the kernel writes it, it equals ``accel/numerics.py::af_quantize``
  bitwise on 2^20 float32 inputs spread over every bias from -135 to 120
  (windows from all below the normals to the top binade: NaN only at
  -135, whose powers are all 0 and their reciprocals all infinite, as in
  the compiled reference), and on the boundary set of
  ``tests/test_torch_numerics.py`` (powers of two and the floats just
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
#: every bias whose window meets the float32 range, and two below it
BIASES = range(-135, 128 - (2 ** SPEC.n_exp - 1) + 1)


def _window(e_lo: torch.Tensor):
    """The kernel's per-block tables (``af_window``): exp2_ref(e_lo + i) and
    exp2_neg(e_lo + i) for i in [0, 2^n_exp), one row per bias."""
    e = e_lo[..., None] + torch.arange(2 ** SPEC.n_exp, dtype=torch.float32)
    return tn.exp2_ref(e), tn.exp2_neg(e)


def _power(table: torch.Tensor, e_lo: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The kernel's ``power``: the table's entry at e - e_lo, clamped to the
    window (NaN reads the first entry)."""
    i = torch.nan_to_num(e - e_lo, nan=0.0).clamp(0, 2 ** SPEC.n_exp - 1).long()
    return torch.gather(table, -1, i[..., None])[..., 0]


def _af_quant_kernel(x: torch.Tensor, e_lo: torch.Tensor) -> torch.Tensor:
    """``af_quant`` of csrc/af_gemm.cu, operation for operation."""
    m = SPEC.n_man
    e_hi = e_lo + (2 ** SPEC.n_exp - 1)
    top = torch.tensor(2.0 - 2.0 ** -m)
    p, inv_p = 2.0 ** m, 2.0 ** -m
    table, recip = _window(e_lo)
    vmax = top * table[..., -1]
    flush = tn._flush(table[..., 0] * 0.5)
    x = tn._flush(x)
    one = torch.ones_like(x)
    sign = torch.where(x > 0, one, torch.where(x < 0, -one, x))
    ax = x.abs()
    safe = torch.where(ax > 0, ax, torch.ones_like(ax))
    e = torch.clamp(tn.floor_log2(safe), e_lo, e_hi)
    man = torch.clamp(tn._flush(ax * _power(recip, e_lo, e)), torch.tensor(1.0), top)
    man_q = torch.round(man * p) * inv_p
    bump = man_q >= 2.0
    e2 = torch.clamp(e + bump.float(), e_lo, e_hi)
    man_q = torch.where(bump & (e2 > e), torch.ones_like(man_q), torch.minimum(man_q, top))
    q = torch.minimum(man_q * _power(table, e_lo, e2), vmax)
    q = torch.where(ax < flush, torch.zeros_like(q), q)
    return sign * q


def _differ(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Where the float32 bits differ (any NaN equals any NaN)."""
    nan = torch.isnan(got) & torch.isnan(want)
    return torch.nonzero((got.view(torch.int32) != want.view(torch.int32)) & ~nan).flatten()


def _random_inputs(n_per_bias: int, seed: int = 0):
    """float32 values whose binades cover each bias's window, three binades
    below it (flush) and two above (saturation), random mantissas and
    signs; returned with each value's bias."""
    rng = np.random.default_rng(seed)
    biases = np.repeat(np.asarray(BIASES, np.int64), n_per_bias)
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


@pytest.mark.parametrize("bias", [float("nan"), float("inf"), -float("inf")])
def test_fast_window_range_keeps_powers_normal(bias):
    """Every power in the kernel's window table is 0, a normal float or +inf and
    equals the plain version's table (``exp2_ref_int``) at every bias; a
    NaN or an infinite bias gives a table of one repeated value, so that
    the kernel's clamped index reads what the plain version reads."""
    e_lo = torch.arange(-140, BIASES.stop, dtype=torch.float32)
    e = e_lo[:, None] + torch.arange(2 ** SPEC.n_exp, dtype=torch.float32)
    for table, want in zip(_window(e_lo), (tn.exp2_ref_int(e), tn.exp2_neg_int(e))):
        assert bool(((table == 0) | (table >= tn.MIN_NORMAL)).all())  # + inf at the ends
        assert torch.equal(table, want)
    for odd in _window(torch.tensor([bias])):
        assert torch.equal(odd.isnan(), odd[:, :1].isnan().expand_as(odd))
        assert torch.equal(odd.nan_to_num(), odd[:, :1].nan_to_num().expand_as(odd))
    x = torch.tensor([0.0, 1e-30, -3.0, 1e30, float("inf"), float("nan")])
    e_lo = torch.full_like(x, bias)
    assert _differ(_af_quant_kernel(x, e_lo), tn.af_quantize(x, SPEC, exp_bias=e_lo)).numel() == 0


def test_af_fast_quantizer_bit_exact_on_2_20_random_inputs():
    x, bias = _random_inputs(-(-2 ** 20 // len(BIASES)))
    assert x.numel() >= 2 ** 20 and bool(torch.isfinite(x).all())
    want = tn.af_quantize(x, SPEC, exp_bias=bias)
    got = _af_quant_kernel(x, bias)
    bad = _differ(got, want)
    assert bad.numel() == 0, list(zip(x[bad][:8].tolist(), bias[bad][:8].tolist(),
                                     got[bad][:8].tolist(), want[bad][:8].tolist()))
    # a window whose powers all flush and whose reciprocals are all infinite
    # (-135): 0 * inf below it, NaN as in the compiled reference
    assert bool(torch.isnan(want[bias <= -135]).any())
    assert bool(torch.isfinite(want[bias > -135]).all())


@pytest.mark.parametrize("bias", [-135.0, -133.0, -130.0, -126.0, -100.0, -20.0, -10.0, -7.0,
                                  -5.0, -3.0, 0.0, 2.0, 13.0, 60.0, 119.0, 120.0])
def test_af_fast_quantizer_bit_exact_on_boundaries(bias):
    x = torch.from_numpy(_boundary_inputs(bias))
    e_lo = torch.full_like(x, bias)
    want = tn.af_quantize(x, SPEC, exp_bias=e_lo)
    got = _af_quant_kernel(x, e_lo)
    bad = _differ(got, want)
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
