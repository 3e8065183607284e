"""PyTorch port: ``kernels/ref.py::af_gemm_ref`` in the reference's order.

The reference's Pallas ``af_gemm`` is compiled (``jax.jit``; interpret mode
on the CPU, as the JAX tests run it): its quantizer takes the compiled form
(``numerics.tier``), its K runs in 128-wide blocks of sequential fp32
fused multiply-adds added in order, then ``+ b`` in fp32, denormals read and
written as zeros of their sign. ``af_gemm_ref`` computes that order, and
gives the kernel's bits:

* from x's largest magnitude 2^-126 (its window all below the normals:
  finite outputs, where the eager form gives NaN) to 1e30, at one K block
  and three, on a grid of one block (a -0 sum stays -0) and of two (+0);
* on chip_smoke's case with x on the lattice midpoints of [-20, -13],
  where the two tiers quantize x apart;
* on zero sums, whose sign the padding of K to 128 decides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import jax
from repro.accel import numerics as jn
from repro.kernels import af_gemm as jaf
from repro.kernels.ops import _pad_to
from repro_torch.accel import numerics as tn
from repro_torch.kernels import ref

J_SPEC = jn.AdaptivFloatSpec(8, 3)
T_SPEC = tn.AdaptivFloatSpec(8, 3)


def _differ(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Indices where the float32 bits differ (any NaN equals any NaN)."""
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    nan = np.isnan(got) & np.isnan(want)
    return np.flatnonzero((got.view(np.uint32) != want.view(np.uint32)) & ~nan)


def _pallas(x, w, b, bx, bw, bo):
    """The reference's Pallas af_gemm, padded to its 128 blocks as
    ``repro.kernels.ops.af_linear`` pads."""
    M, N = x.shape[0], w.shape[0]
    xp = _pad_to(_pad_to(jnp.asarray(x), 128, 0), 128, 1)
    wp = _pad_to(_pad_to(jnp.asarray(w), 128, 0), 128, 1)
    out = jaf.af_gemm(xp, wp, _pad_to(jnp.asarray(b), 128, 0), bx, bw, bo,
                      spec=J_SPEC, interpret=True)
    return np.asarray(out)[:M, :N]


def _af_case(x, w, b):
    X, W, B = (torch.from_numpy(a) for a in (x, w, b))
    bx, bw = (float(v) for v in tn.af_exp_biases([X, W], T_SPEC))
    bo = float(tn.af_exp_bias(X @ W.T + B, T_SPEC))
    want = _pallas(x, w, b, bx, bw, bo)
    got = ref.af_gemm_ref(X, W, B, bx, bw, bo, T_SPEC).numpy()
    return got, want


@pytest.mark.parametrize("M,K", [(128, 128), (128, 384), (256, 128)])
@pytest.mark.parametrize("amax", [2.0 ** -126, 2.0 ** -122, 1e-30, 1e-6, 1.0, 1e12, 1e30])
def test_af_gemm_ref_equals_the_pallas_kernel(amax, M, K):
    """x's largest magnitude ``amax``, w ~ N(0, 0.01), b at amax / 10: the
    windows of x from all below the normals (2^-126: its outputs finite,
    where the eager form gave NaN) to 1e30; one K block or three; a grid of
    one block (a -0 sum stays -0) or two (+0). Bit for bit."""
    rng = np.random.default_rng(K + M)
    x = rng.standard_normal((M, K))
    x = (x / np.abs(x).max() * amax).astype(np.float32)
    w = (rng.standard_normal((128, K)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1 * amax).astype(np.float32)
    got, want = _af_case(x, w, b)
    bad = _differ(got, want)
    assert bad.size == 0, (got.ravel()[bad][:6], want.ravel()[bad][:6])
    assert np.isfinite(got).all()


def _fma_step_cases():
    """(a, b, c) float32 triples: float64 sums that land on a float32 tie
    (c = 1 + 2^-23, a b = 2^-24 (1 - m^2 2^-46) for m < 362, so that the
    float64 sum is the tie and rounds to even, where the exact sum lies
    below it), both signs;
    sums near and below 2^-126 and exact zeros of either sign; random
    values over the whole exponent range."""
    m = np.arange(1, 362, dtype=np.float64)
    a = 2.0 ** -24 * (1 + m * 2.0 ** -23)
    b = 1 - m * 2.0 ** -23
    c = np.full_like(m, 1 + 2.0 ** -23)
    t = 2.0 ** -126
    edge_a = np.array([t, t, -t, 2 ** -70, -(2 ** -70), 0.0, -0.0, 1.0, 2 ** -63])
    edge_b = np.array([0.5, -0.5 - 2 ** -24, 0.5, 2 ** -57, 2 ** -57, 1.0, 1.0, -1.0, 2 ** -63])
    edge_c = np.array([t / 2, t, t / 2 + t, t, -0.0, -0.0, -0.0, 1.0, t])
    rng = np.random.default_rng(7)
    ra = rng.standard_normal(1 << 16) * 2.0 ** rng.integers(-140, 50, 1 << 16)
    rb = rng.standard_normal(1 << 16) * 2.0 ** rng.integers(-60, 50, 1 << 16)
    rc = rng.standard_normal(1 << 16) * np.abs(ra * rb) * 2.0 ** rng.integers(-30, 20, 1 << 16)
    cols = [np.concatenate(v).astype(np.float32) for v in (
        (a, -a, edge_a, ra), (b, b, edge_b, rb), (c, -c, edge_c, rc))]
    return [torch.from_numpy(v) for v in cols]


def test_fma_step_is_the_exact_fma_with_denormals_flushed():
    """``ref._fma_step`` (the float64 sum rounded once more, recomputed at
    ties and at the subnormal edge) equals ``numerics._fma`` then
    ``_flush`` at every case, the ties included."""
    a, b, c = _fma_step_cases()
    c = tn._flush(c)
    want = tn._flush(tn._fma(a, b, c)).numpy()
    got = ref._fma_step(a.double(), b.double(), c).numpy()
    assert _differ(got, want).size == 0
    # the ties: one rounding from float64 alone would give another float32
    once = (a.double() * b.double() + c.double()).float().numpy()[:722]
    assert _differ(once, want[:722]).size == 722


@pytest.mark.parametrize("K", [48, 64, 128])
def test_af_gemm_ref_signs_a_zero_sum_as_the_padded_kernel(K):
    """chip_smoke's signed-zero case: every product flushed from a tiny
    negative, b = -0, a grid of one block. The reference pads K to 128 with
    zeros, and a padded k's fma(0, 0, -0) is +0: the outputs are +0 at
    K = 48 and 64 and -0 at K = 128, where nothing is padded. Bit for bit."""
    x, w, b, bx, bw, bo = chip_smoke.af_signed_zero_case("cpu", K)
    want = _pallas(x.numpy(), w.numpy(), b.numpy(), bx, bw, bo)
    got = ref.af_gemm_ref(x, w, b, bx, bw, bo, T_SPEC).numpy()
    assert not want.any() and np.signbit(want).all() == (K == 128) == np.signbit(want).any()
    assert _differ(got, want).size == 0


def test_af_gemm_ref_on_chip_smokes_midpoint_case():
    """chip_smoke's af_gemm case on the lattice midpoints of [-20, -13]:
    the tiers quantize x apart, and af_gemm_ref gives the Pallas kernel's
    bits (the compiled form)."""
    x, w, b, bx, bw, bo = chip_smoke.af_midpoint_case(np.random.default_rng(0), "cpu", T_SPEC)
    assert float(bx) == chip_smoke.AF_MID_BIAS
    with tn.tier("eager"):
        eager = tn.af_quantize(x, T_SPEC, bx)
    assert _differ(eager.numpy(), tn.af_quantize(x, T_SPEC, bx).numpy()).size > 0
    got = ref.af_gemm_ref(x, w, b, bx, bw, bo, T_SPEC).numpy()
    want = _pallas(x.numpy(), w.numpy(), b.numpy(), float(bx), float(bw), float(bo))
    assert _differ(got, want).size == 0 and np.isfinite(got).all()


@pytest.mark.parametrize("B,shared", [(1, True), (2, True), (2, False)])
def test_the_ila_linears_matmul_sums_in_the_references_order(B, shared):
    """FlexASR's ILA linear sums ``Xq @ Wq^T`` at (B, MAX_TS, MAX_IN) by
    (MAX_OUT, MAX_IN): one K block of 128. The reference's is XLA's dot,
    a sequential fp32 FMA chain over k at that shape op by op, under
    ``jit`` and under ``vmap`` (its batched tiers); the port's is torch's
    matmul, which gives that chain here too. On full-mantissa data, where
    every other order rounds apart, all equal ``af_block_sums`` bit for
    bit."""
    from repro_torch.accel import flexasr as tfa

    rng = np.random.default_rng(B)
    x = rng.standard_normal((B, tfa.MAX_TS, tfa.MAX_IN)).astype(np.float32)
    w = rng.standard_normal((1 if shared else B, tfa.MAX_OUT, tfa.MAX_IN)).astype(np.float32)
    chain = ref.af_block_sums(torch.from_numpy(x), torch.from_numpy(w), one_block=True).numpy()
    port = (torch.from_numpy(x) @ torch.from_numpy(w).mT).numpy()
    wb = np.broadcast_to(w, (B,) + w.shape[1:])
    eager = np.stack([np.asarray(jnp.asarray(x[i]) @ jnp.asarray(wb[i]).T) for i in range(B)])
    batched = np.asarray(jax.jit(jax.vmap(lambda a, b: a @ b.T))(x, np.ascontiguousarray(wb)))
    for got in (port, eager, batched):
        assert _differ(got, chain).size == 0
    # the float64 sum rounded once: most outputs round apart from the chain
    once = (torch.from_numpy(x).double() @ torch.from_numpy(w).double().mT).float().numpy()
    assert _differ(once, chain).size > chain.size // 4
