"""PyTorch port: accelerator numerics against the JAX reference.

AdaptivFloat quantization is bit-exact with ``repro.accel.numerics`` on
random data at every scale, at the exact powers of two and their
neighbours, and on the lattice's boundary inputs: powers of two and the
floats just below them, lattice midpoints (round half to even), 0, the
saturation edge, vmin/2 and 4.5. The port computes the reference's own
log and exp2 (``numerics.log_f32``, ``numerics.exp2_ref``: XLA's CPU
algorithm), so the exponent ``floor(log(x) * float32(1 / ln 2))`` picks the
reference's binade at every power of two, and the powers of two are the
reference's ``jnp.exp2``, which misses 2^e by an ulp or more at most
exponents outside [-12, 12] and is 0 at e <= -126. Subnormal inputs read
as 0, as XLA reads them.
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
    """The port's eager form, as ``_jax_q`` runs the reference op by op."""
    with tn.tier("eager"):
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
    """|e| >= 13: the port gives the reference's values, on the lattice its
    ``jnp.exp2`` builds (an ulp or more off 2^e there)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20_000) * 1e-3).astype(np.float32)
    got, want = _port_q(x, None), _jax_q(x, None)
    np.testing.assert_array_equal(got, want)
    assert float(tn.af_exp_bias(torch.from_numpy(x), T_SPEC)) <= -13


def test_exp2_int_exact():
    """``exp2_ref`` and its table ``exp2_ref_int`` equal ``jnp.exp2`` at
    every integer in [-149, 127] (and beyond, where it stays constant)."""
    e = np.arange(-149, 128, dtype=np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(e)))
    np.testing.assert_array_equal(tn.exp2_ref(torch.from_numpy(e)).numpy(), want)
    np.testing.assert_array_equal(tn.exp2_ref_int(torch.from_numpy(e)).numpy(), want)
    far = np.array([-1e6, -300, -128, 128, 129, 130, 300, 1e6], np.float32)
    np.testing.assert_array_equal(tn.exp2_ref_int(torch.from_numpy(far)).numpy(),
                                  np.asarray(jnp.exp2(jnp.asarray(far))))
    exact = [int(k) for k, v in zip(e, want) if v == 2.0 ** float(k)]
    assert exact == [-14] + list(range(-12, 13)) + [14, 16, 18, 20, 22, 24, 28]
    assert (want[e <= -126] == 0).all()


def test_af_ste_identity_gradient():
    x = torch.linspace(-2, 2, 33, requires_grad=True)
    y = tn.af_ste(x, T_SPEC)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(33, np.float32))
    np.testing.assert_array_equal(y.detach().numpy(), _port_q(x.detach().numpy(), None))


#: the exponents e at which floor(log2(2^e)) is e - 1 in the reference (XLA's
#: log(x) * float32(1 / ln 2) rounds below e) and in the port alike
POWERS_BELOW = (13, 15, 26, 27, 30, 31, 49, 52, 54, 57, 60, 62, 93, 98, 103, 104, 108, 109,
                114, 119, 120, 124, 125)
#: the largest subnormal, 2^-126 one ulp down: XLA on the CPU reads it as
#: zero (floor(log2) -inf, bias -7 from amax 1.0), and so does the port
LARGEST_SUBNORMAL = np.nextafter(np.float32(2.0 ** -126), np.float32(0))


def _powers_and_neighbours():
    """2^e for e in [-126, 127], one ulp below and one above each, both
    signs: 1524 float32 values."""
    p = np.ldexp(np.float32(1.0), np.arange(-126, 128)).astype(np.float32)
    x = np.concatenate([p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf))])
    return np.concatenate([x, -x])


def test_floor_log2_and_bias_equal_the_reference_at_every_power_of_two():
    x = _powers_and_neighbours()
    ax = np.abs(x)
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(ax))))
    got = tn.floor_log2(torch.from_numpy(ax)).numpy()
    np.testing.assert_array_equal(got, want)
    sub = ax == LARGEST_SUBNORMAL
    assert sub.sum() == 2 and (got[sub] == -np.inf).all()
    for v in x:
        a = np.array([v], np.float32)
        want_b = float(jn.af_exp_bias(jnp.asarray(a), J_SPEC))
        got_b = float(tn.af_exp_bias(torch.from_numpy(a), T_SPEC))
        assert got_b == want_b, (v, got_b, want_b)
        assert abs(v) != LARGEST_SUBNORMAL or got_b == -7.0
    # the three magnitudes of one tensor, as a tensor's amax meets them
    for e in range(-126, 128):
        a = np.array([2.0 ** e, -(2.0 ** e) / 3, 2.0 ** e / 100], np.float32)
        assert float(tn.af_exp_bias(torch.from_numpy(a), T_SPEC)) == float(
            jn.af_exp_bias(jnp.asarray(a), J_SPEC)), e


def test_af_quantize_equals_the_reference_at_every_power_of_two():
    """No bias given (each value its own tensor): equal to the reference at
    every point, where its ``jnp.exp2`` misses 2^e and at the subnormal
    neighbour of 2^-126 (read as 0) alike."""
    import jax

    x = _powers_and_neighbours()
    want = np.asarray(jax.vmap(lambda a: jn.af_quantize(a, J_SPEC))(jnp.asarray(x[:, None])))[:, 0]
    with tn.tier("eager"):   # jax.vmap runs the reference op by op
        got = np.array([float(tn.af_quantize(torch.from_numpy(x[i:i + 1]), T_SPEC)[0])
                        for i in range(x.size)], np.float32)
    np.testing.assert_array_equal(got, want)
    # off the exact lattice where the reference's exp2 misses the power
    mant, _ = np.frexp(np.abs(got[got != 0]).astype(np.float64))
    assert (mant * 32 != np.round(mant * 32)).any()


@pytest.mark.parametrize("sigma", [1e-6, 1e-3, 1.0, 1e3])
def test_af_quantize_bit_exact_on_the_sigma_sweep(sigma):
    """Seeded N(0, sigma^2) tensors: windows from [-27, -20] to [3, 10],
    no bias given and the bias shifted down and up by 9 exponents."""
    rng = np.random.default_rng(int(np.log10(sigma)) + 10)
    x = (rng.standard_normal(16_384) * sigma).astype(np.float32)
    bias = float(jn.af_exp_bias(jnp.asarray(x), J_SPEC))
    for b in (None, bias - 9, bias + 9):
        np.testing.assert_array_equal(_port_q(x, b), _jax_q(x, b), err_msg=str(b))


def test_floor_log2_multiplies_by_the_float32_reciprocal_of_ln2():
    """On a log-spaced sweep and at the powers of two and their neighbours,
    ``floor_log2`` is floor(log_f32(x) * 0x3fb8aa3b), the product rounded to
    float32, never the quotient by ln 2, and equals the reference's."""
    powers = _powers_and_neighbours()
    x = np.concatenate([np.geomspace(1e-37, 1e37, 200_001).astype(np.float32),
                        powers[(powers > 0) & (powers != LARGEST_SUBNORMAL)]])
    logs = tn.log_f32(torch.from_numpy(x)).numpy()
    inv_ln2 = np.uint32(0x3fb8aa3b).view(np.float32)
    assert np.float32(tn.INV_LN2) == inv_ln2
    got = tn.floor_log2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.floor(logs * inv_ln2))
    np.testing.assert_array_equal(got, np.asarray(jnp.floor(jnp.log2(jnp.asarray(x)))))
    # the product and the quotient part at exact powers of two
    p = np.ldexp(np.float32(1.0), np.arange(-126, 128)).astype(np.float32)
    lp = tn.log_f32(torch.from_numpy(p)).numpy()
    assert (np.floor(lp * inv_ln2) != np.floor(lp / np.float32(np.log(2)))).any()


def test_reference_floor_log2_is_one_below_at_the_listed_powers():
    """A reference fact the port keeps: floor(log2(2^e)) is e - 1 at these
    exponents, and exact at every other e in [-126, 127], in both."""
    e = np.arange(-126, 128)
    p = np.ldexp(np.float32(1.0), e).astype(np.float32)
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(p))))
    got = tn.floor_log2(torch.from_numpy(p)).numpy()
    assert tuple(e[want != e]) == POWERS_BELOW
    assert tuple(e[got != e]) == POWERS_BELOW
    assert (want[want != e] == e[want != e] - 1).all()
    np.testing.assert_array_equal(got, want)


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


def _aten_ops(fn) -> int:
    """The aten ops ``fn`` dispatches: on the card each is a launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def test_af_exp_biases_take_one_exponent_for_three():
    """af_linear's three biases in one ``floor_log2``: each as alone, in
    little more than the ops of one."""
    spec = tn.AdaptivFloatSpec(8, 3)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy((rng.standard_normal((16, 64)) * s).astype(np.float32))
          for s in (1e-3, 1.0, 40.0)]
    stacked = tn.af_exp_biases(xs, spec)
    assert torch.equal(stacked, torch.stack([tn.af_exp_bias(x, spec) for x in xs]))
    one = _aten_ops(lambda: tn.af_exp_bias(xs[0], spec))
    three = _aten_ops(lambda: tn.af_exp_biases(xs, spec))
    assert three < 1.2 * one, (one, three)
