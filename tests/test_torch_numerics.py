"""PyTorch port: accelerator numerics against the JAX reference.

AdaptivFloat quantization is bit-exact with ``repro.accel.numerics`` on
random data and on the lattice's boundary inputs: powers of two and the
floats just below them, lattice midpoints (round half to even), 0, the
saturation edge, vmin/2 and 4.5. The exponent is ``floor(log(x) / ln 2)``
in both, so just below a power of two both pick the same binade.

One documented divergence: ``jnp.exp2`` on the CPU backend misses exact
powers of two for some exponents of magnitude 13 and more, so there the
reference's values fall off the AF lattice by an ulp; the port builds 2^e
from exponent bits and stays on the lattice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import numerics as jn
from repro_torch.accel import numerics as tn

J_SPEC = jn.AdaptivFloatSpec(8, 3)
T_SPEC = tn.AdaptivFloatSpec(8, 3)


def _jax_q(x, bias):
    return np.asarray(jn.af_quantize(jnp.asarray(x), J_SPEC, exp_bias=bias))


def _port_q(x, bias):
    return tn.af_quantize(torch.from_numpy(x), T_SPEC, exp_bias=bias).numpy()


def _boundary_inputs(bias):
    m = T_SPEC.n_man
    e_lo, e_hi = bias, bias + 2 ** T_SPEC.n_exp - 1
    vals = [0.0, 4.5, -4.5]
    for k in range(-12, 13):
        p = np.float32(2.0 ** k)
        below = np.nextafter(p, np.float32(0))
        vals += [p, below, np.nextafter(below, np.float32(0)), np.nextafter(p, np.float32(1e9))]
    # lattice midpoints of every binade in the window: ties round to even
    for e in range(int(e_lo), int(e_hi) + 1):
        steps = np.arange(2 ** m, 2 ** (m + 1)) + 0.5
        vals += list(steps * 2.0 ** (e - m))
    vmax = (2 - 2.0 ** -m) * 2.0 ** e_hi
    vmin = 2.0 ** e_lo
    for v in (vmax, vmin / 2, vmin):
        f = np.float32(v)
        vals += [f, np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(1e9))]
    x = np.asarray(vals, np.float32)
    return np.concatenate([x, -x])


@pytest.mark.parametrize("bias", [-10.0, -7.0, -5.0, -3.0, 0.0, 2.0])
def test_af_quantize_bit_exact_on_boundaries(bias):
    x = _boundary_inputs(bias)
    want, got = _jax_q(x, bias), _port_q(x, bias)
    bad = np.flatnonzero(want != got)
    assert bad.size == 0, list(zip(x[bad][:8], want[bad][:8], got[bad][:8]))


@pytest.mark.parametrize("scale", [0.05, 0.3, 1.0, 3.0])
@pytest.mark.parametrize("bias", [None, -8.0, -6.0, -2.0])
def test_af_quantize_bit_exact_random(scale, bias):
    rng = np.random.default_rng(int(scale * 100) + (0 if bias is None else int(-bias)))
    x = (rng.standard_normal(50_000) * scale).astype(np.float32)
    np.testing.assert_array_equal(_port_q(x, bias), _jax_q(x, bias))


def test_af_exp_bias_matches():
    rng = np.random.default_rng(3)
    for scale in [1e-3, 0.1, 1.0, 7.9, 8.0, 100.0]:
        x = (rng.standard_normal((17, 9)) * scale).astype(np.float32)
        want = float(jn.af_exp_bias(jnp.asarray(x), J_SPEC))
        assert float(tn.af_exp_bias(torch.from_numpy(x), T_SPEC)) == want
    zero = np.zeros((4,), np.float32)
    assert float(tn.af_exp_bias(torch.from_numpy(zero), T_SPEC)) == float(
        jn.af_exp_bias(jnp.asarray(zero), J_SPEC))


def test_round_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x.numpy()))))


def test_below_power_of_two_picks_the_rounded_binade():
    """The exponent is floor of the *rounded* log2: where log(x)/ln2 rounds
    up to k, x just below 2^k lands in binade k (mantissa clamps to 1.0), in
    the reference and the port alike; where it does not, binade k-1 with
    the mantissa clamped to 2 - 2^-4 (the reference never bumps a mantissa
    past that clamp)."""
    for k in range(-12, 13):
        below = np.nextafter(np.float32(2.0 ** k), np.float32(0))
        x = np.array([below], np.float32)
        bias = float(k - 4)
        got = _port_q(x, bias)[0]
        assert got == _jax_q(x, bias)[0]
        e = float(tn.floor_log2(torch.from_numpy(x))[0])
        assert e in (k - 1, k)
        assert got == (2.0 ** k if e == k else (2 - 2.0 ** -4) * 2.0 ** (k - 1))


def test_tiny_exponents_stay_on_the_lattice():
    """|e| >= 13: the port is exact; the reference's exp2 is off by ulps."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20_000) * 1e-3).astype(np.float32)
    got, want = _port_q(x, None), _jax_q(x, None)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    mant, _ = np.frexp(np.abs(got[got != 0]).astype(np.float64))
    # 5 significant bits: mantissa * 2^5 is an integer
    np.testing.assert_array_equal(mant * 32, np.round(mant * 32))


def test_exp2_int_exact():
    e = torch.arange(-149, 128, dtype=torch.float32)
    want = np.ldexp(np.float64(1.0), e.numpy().astype(int)).astype(np.float32)
    np.testing.assert_array_equal(tn.exp2_int(e).numpy(), want)


def test_af_ste_identity_gradient():
    x = torch.linspace(-2, 2, 33, requires_grad=True)
    y = tn.af_ste(x, T_SPEC)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(33, np.float32))
    np.testing.assert_array_equal(y.detach().numpy(), _port_q(x.detach().numpy(), None))


@pytest.mark.parametrize(
    "spec_name", ["HLSCNN_WEIGHT_ORIGINAL", "HLSCNN_WEIGHT_UPDATED", "HLSCNN_ACT"])
def test_fixed_point_matches(spec_name):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(10_000) * 4).astype(np.float32)
    x[:6] = [0.0625, -0.0625, 0.1875, 300.0, -300.0, 0.5]
    want = np.asarray(jn.fx_quantize(jnp.asarray(x), getattr(jn, spec_name)))
    got = tn.fx_quantize(torch.from_numpy(x), getattr(tn, spec_name)).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_matches():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    qj, sj = jn.int8_quantize(jnp.asarray(x))
    qt, st = tn.int8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    np.testing.assert_array_equal(tn.int8_dequantize(qt, st).numpy(),
                                  np.asarray(jn.int8_dequantize(qj, sj)))


@pytest.mark.parametrize("numerics", ["adaptivfloat8", "fixed16", "int8"])
def test_saturation_and_grid(numerics):
    assert tn.saturation_point(numerics) == jn.saturation_point(numerics)
    assert tn.rounding_grid(numerics) == jn.rounding_grid(numerics)
