"""PyTorch port: the reference's log, exp and exp2 (XLA's CPU algorithm).

``repro_torch.accel.numerics`` computes ``jnp.log``, ``jnp.exp`` and
``jnp.exp2`` as XLA compiles them for the CPU (Cephes's polynomials, the
multiply-adds XLA fuses fused, denormals as zero). Each is held here to the
JAX package bit for bit:

* ``floor_log2`` and ``af_exp_bias`` on the +-2048-ulp band around each of
  the 254 normal powers of two, both signs, and on 2^20 seeded random
  normal floats; among them 0x6e7ffff3, 13 ulps below 2^94, where
  ``floor(torch.log(x) * (1 / ln 2))`` gives 93 and the reference 94;
* ``log_f32`` and ``exp_f32`` on seeded random bit patterns (every sign,
  binade and special value), ``exp2_ref`` at every integer in [-149, 127];
* VecUnit's sigmoid ``1 / (1 + exp(-a))`` before its output rounding on
  the int16 grids k * 2^ea, ea in {-13, -14, -15}, every k in [-32767,
  32767];
* ``kernels/ref.py::af_gemm_ref`` against the reference's Pallas
  ``af_gemm`` run as the JAX tests run it on the CPU (interpret mode), at
  exponent windows outside [-12, 12], where ``jnp.exp2`` misses the
  powers of two, and at K = 512, four of the reference's 128-wide K
  blocks: the port sums in the reference's order (fp32 fused multiply-adds
  per block, the blocks in order), so every output is the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import numerics as jn
from repro.kernels import af_gemm as jaf
from repro_torch.accel import numerics as tn
from repro_torch.kernels import ref

J_SPEC = jn.AdaptivFloatSpec(8, 3)
T_SPEC = tn.AdaptivFloatSpec(8, 3)
#: 13 ulps below 2^94: floor(log2) 94 in the reference, 93 through torch.log
HARD_POINT = np.uint32(0x6e7ffff3).view(np.float32)


def _band(ulps: int = 2048) -> np.ndarray:
    """Every positive normal float within ``ulps`` of a power of two."""
    p = np.arange(1, 255, dtype=np.int64) << 23
    bits = (p[:, None] + np.arange(-ulps, ulps + 1)[None, :]).ravel()
    bits = bits[(bits >= 1 << 23) & (bits < 0x7f800000)]
    return bits.astype(np.uint32).view(np.float32)


def _random_normals(n: int = 2 ** 20) -> np.ndarray:
    rng = np.random.default_rng(28)
    bits = rng.integers(0x00800000, 0x7f800000, n, dtype=np.uint32)
    return bits.view(np.float32)


def _equal_bits(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Indices where the float32 bits differ (any NaN equals any NaN)."""
    nan = np.isnan(got) & np.isnan(want)
    return np.flatnonzero((got.view(np.uint32) != want.view(np.uint32)) & ~nan)


@pytest.mark.parametrize("points", ["band", "random"])
def test_floor_log2_equals_the_reference(points):
    x = _band() if points == "band" else np.append(_random_normals(), HARD_POINT)
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(x))))
    got = tn.floor_log2(torch.from_numpy(x)).numpy()
    bad = _equal_bits(got, want)
    assert bad.size == 0, list(zip(x[bad][:8], got[bad][:8], want[bad][:8]))
    i = int(np.flatnonzero(x == HARD_POINT)[0])
    assert got[i] == 94.0
    assert float(torch.floor(torch.log(torch.from_numpy(x[i:i + 1])) * tn.INV_LN2)) == 93.0


@pytest.mark.parametrize("points", ["band", "random"])
def test_af_exp_bias_equals_the_reference(points):
    """Each value a tensor of its own, both signs."""
    x = _band() if points == "band" else _random_normals()
    x = np.concatenate([x, -x[::3]])[:, None]
    want = np.asarray(jax.vmap(lambda a: jn.af_exp_bias(a, J_SPEC))(jnp.asarray(x)))
    got = torch.func.vmap(lambda a: tn.af_exp_bias(a, T_SPEC))(torch.from_numpy(x)).numpy()
    bad = _equal_bits(got, want)
    assert bad.size == 0, list(zip(x[bad, 0][:8], got[bad][:8], want[bad][:8]))


def _random_bits(n: int = 2 ** 20) -> np.ndarray:
    rng = np.random.default_rng(16)
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1.1754942e-38,
                        1.1754944e-38, 1.0, -1.0, 88.7, 88.8, 88.9, -87.7, -87.8, -87.9,
                        -103.0], np.float32)
    return np.concatenate([x, special])


@pytest.mark.parametrize("fn", ["log", "exp"])
def test_log_and_exp_equal_the_reference_on_random_bits(fn):
    x = _random_bits()
    if fn == "log":
        want, got = jnp.log(jnp.asarray(x)), tn.log_f32(torch.from_numpy(x))
    else:
        want, got = jnp.exp(jnp.asarray(x)), tn.exp_f32(torch.from_numpy(x))
    want, got = np.asarray(want), got.numpy()
    bad = _equal_bits(got, want)
    assert bad.size == 0, list(zip(x[bad][:8], got[bad][:8], want[bad][:8]))


def test_exp2_ref_equals_the_reference_at_every_integer():
    e = np.arange(-149, 128, dtype=np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(e)))
    got = tn.exp2_ref(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # not the exact powers: 244 of 277 miss 2^e, by up to 17 ulps in
    # [-30, 30] (at -26) and 67 in [-125, 127] (at -104)
    exact = np.ldexp(np.float32(1.0), e.astype(int)).astype(np.float32)
    assert int((got != exact).sum()) == 244
    ulps = np.abs(got.view(np.int32).astype(np.int64) - exact.view(np.int32))
    for lo, hi, most, at in ((-30, 30, 17, -26), (-125, 127, 67, -104)):
        inside = (e >= lo) & (e <= hi)
        assert int(ulps[inside].max()) == most and int(e[inside][ulps[inside].argmax()]) == at


@pytest.mark.parametrize("ea", [-13, -14, -15])
def test_vecunit_sigmoid_on_the_int16_grid(ea):
    """Before the output rounding, at every grid point k * 2^ea."""
    a = (np.arange(-32767, 32768, dtype=np.float64) * 2.0 ** ea).astype(np.float32)
    want = np.asarray(1.0 / (1.0 + jnp.exp(-jnp.asarray(a))))
    got = (1.0 / (1.0 + tn.exp_f32(-torch.from_numpy(a)))).numpy()
    bad = _equal_bits(got, want)
    assert bad.size == 0, list(zip(a[bad][:8], got[bad][:8], want[bad][:8]))
    # torch's own exp rounds otherwise at thousands of these points
    plain = (1.0 / (1.0 + torch.exp(-torch.from_numpy(a)))).numpy()
    assert _equal_bits(plain, want).size > 1000


@pytest.mark.parametrize("scale", [1e-6, 3e-3, 1e3, 1e12])
def test_af_gemm_ref_equals_the_reference_pallas_kernel(scale):
    """The reference's Pallas ``af_gemm`` (interpret mode, 128 x 128 x 128
    blocks), with x and w at ``scale``: every exponent window outside
    [-12, 12] but for 1e3's x and w (bias 5, [5, 12]), whose output
    window lies above 12."""
    rng = np.random.default_rng(int(np.log10(scale)) + 20)
    x = (rng.standard_normal((128, 128)) * scale).astype(np.float32)
    w = (rng.standard_normal((128, 128)) * scale).astype(np.float32)
    b = (rng.standard_normal(128) * scale * scale).astype(np.float32)
    bx = float(tn.af_exp_bias(torch.from_numpy(x), T_SPEC))
    bw = float(tn.af_exp_bias(torch.from_numpy(w), T_SPEC))
    xq = tn.af_quantize(torch.from_numpy(x), T_SPEC, bx)
    wq = tn.af_quantize(torch.from_numpy(w), T_SPEC, bw)
    bo = float(tn.af_exp_bias(xq @ wq.T + torch.from_numpy(b), T_SPEC))
    windows = [(v, v + 7) for v in (bx, bw, bo)]
    assert sum(lo < -12 or hi > 12 for lo, hi in windows) >= (1 if scale == 1e3 else 3), windows
    want = np.asarray(jaf.af_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), bx, bw, bo,
                                  spec=J_SPEC, interpret=True))
    got = ref.af_gemm_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                          bx, bw, bo, T_SPEC).numpy()
    bad = _equal_bits(got, want)
    assert bad.size == 0, list(zip(got.ravel()[bad][:8], want.ravel()[bad][:8]))
    assert np.isfinite(got).all() and (got != 0).mean() > 0.5


#: outputs where af_gemm_ref and the reference's Pallas kernel differ, of
#: 256 x 128 at K = 512 (a float64 sum differed at one output at 1e12)
K512_DIFFER = {1e-6: 0, 1e-3: 0, 1e3: 0, 1e12: 0}


@pytest.mark.parametrize("scale", sorted(K512_DIFFER))
def test_af_gemm_ref_float64_sum_against_the_reference_at_k_512(scale):
    """Four K blocks of the reference's fp32 sums against the port's,
    taken in the same order: no output differs."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((256, 512)) * scale).astype(np.float32)
    w = (rng.standard_normal((128, 512)) * scale).astype(np.float32)
    b = (rng.standard_normal(128) * scale * scale).astype(np.float32)
    X, W, B = (torch.from_numpy(a) for a in (x, w, b))
    bx, bw = (float(v) for v in tn.af_exp_biases([X, W], T_SPEC))
    xq, wq = tn.af_quantize(X, T_SPEC, bx), tn.af_quantize(W, T_SPEC, bw)
    bo = float(tn.af_exp_bias(xq @ wq.T + B, T_SPEC))
    want = np.asarray(jaf.af_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), bx, bw, bo,
                                  spec=J_SPEC, interpret=True))
    got = ref.af_gemm_ref(X, W, B, bx, bw, bo, T_SPEC).numpy()
    bad = _equal_bits(got, want)
    assert bad.size == K512_DIFFER[scale]


def test_af_exp_biases_equal_the_reference_one_tensor_at_a_time():
    """The stacked biases (one ``floor_log2`` for all): zero, subnormal,
    powers of two and their neighbours, infinite and NaN amax."""
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((5, 7)) * s for s in (1e-30, 1e-3, 1.0, 3e4, 1e30)]
    xs += [np.zeros(4), np.full(3, 1e-40), np.array([2.0 ** 94, -1.0]),
           np.array([HARD_POINT]), np.array([1.0, np.inf]), np.array([np.nan, 1.0])]
    xs = [np.asarray(x, np.float32) for x in xs]
    got = tn.af_exp_biases([torch.from_numpy(x) for x in xs], T_SPEC).numpy()
    want = np.array([float(jn.af_exp_bias(jnp.asarray(x), J_SPEC)) for x in xs], np.float32)
    assert _equal_bits(got, want).size == 0, (got, want)
    one = np.array([float(tn.af_exp_bias(torch.from_numpy(x), T_SPEC)) for x in xs], np.float32)
    assert _equal_bits(got, one).size == 0


def test_af_quantize_of_a_tensor_with_nan_equals_the_reference():
    """A NaN sets the bias to NaN: every value is NaN, in the reference and
    in the port (whose power table reads NaN there)."""
    x = np.array([0.0, 1.0, -2.5, np.nan, 1e-3], np.float32)
    want = np.asarray(jn.af_quantize(jnp.asarray(x), J_SPEC))
    got = tn.af_quantize(torch.from_numpy(x), T_SPEC).numpy()
    assert np.isnan(want).all() and _equal_bits(got, want).size == 0

