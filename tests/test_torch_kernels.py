"""PyTorch port: the af_gemm kernel's plain version against the JAX reference.

On the CPU the port's ``af_gemm`` wrapper runs its plain PyTorch version;
it must equal the Pallas kernel (interpret mode) and the reference's
``af_gemm_ref`` bit for bit, on ``tests/test_kernels.py``'s shapes and on
the fused FlexASR runner's batched shape with per-sample exponent biases.
The reference's ``af_gemm_ref`` takes the weight bias first; the port takes
``(exp_bias_x, exp_bias_w, exp_bias_o)`` everywhere, so calls below map
them by keyword. The CUDA kernel itself is held against the plain version
on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import numerics as jn
from repro.kernels import af_gemm as jaf, ops as jops, ref as jref
from repro_torch.accel import flexasr as tfa, numerics as tn
from repro_torch.kernels import af_gemm as taf, ops as tops, ref as tref

J_SPEC = jn.AdaptivFloatSpec(8, 3)
T_SPEC = tn.AdaptivFloatSpec(8, 3)
SHAPES = [(16, 32, 64), (128, 128, 128), (100, 50, 200)]


def _linear_inputs(m, n, k, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((n,)) * 0.1).astype(np.float32)
    return x, w, b


def _fused_inputs(B, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 128, 128)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((256,)) * 0.1).astype(np.float32)
    ba = rng.integers(-7, -4, B).astype(np.float32)
    bo = rng.integers(-5, -2, B).astype(np.float32)
    bw = float(jn.af_exp_bias(jnp.asarray(w), J_SPEC))
    return x, w, b, ba, bw, bo


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_af_linear_equals_pallas_and_ref(m, n, k):
    x, w, b = _linear_inputs(m, n, k)
    pallas = np.asarray(jops.af_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    bx = jn.af_exp_bias(jnp.asarray(x), J_SPEC)
    bw = jn.af_exp_bias(jnp.asarray(w), J_SPEC)
    bo = jn.af_exp_bias(jnp.asarray(x @ w.T + b), J_SPEC)
    jax_ref = np.asarray(jref.af_gemm_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        exp_bias_w=bw, exp_bias_x=bx, exp_bias_o=bo))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    port = tops.af_linear(tx, tw, tb).numpy()
    port_ref = tref.af_gemm_ref(tx, tw, tb, exp_bias_x=float(bx), exp_bias_w=float(bw),
                                exp_bias_o=float(bo)).numpy()
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port_ref, jax_ref)
    np.testing.assert_array_equal(pallas, jax_ref)


def test_fused_batch_equals_pallas_per_sample():
    """B = 4 of the fused runner's (128,128)·(256,128)^T with per-sample
    activation/output biases and one weight bias: the batched plain version
    equals the Pallas kernel run sample by sample."""
    x, w, b, ba, bw, bo = _fused_inputs(4)
    want = np.stack([
        np.asarray(jaf.af_gemm(jnp.asarray(x[i]), jnp.asarray(w), jnp.asarray(b),
                               ba[i], bw, bo[i], interpret=True))
        for i in range(len(x))
    ])
    before = taf.af_gemm.launches
    got = taf.af_gemm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      torch.from_numpy(ba), bw, torch.from_numpy(bo)).numpy()
    assert taf.af_gemm.launches == before  # the CPU runs the plain version
    np.testing.assert_array_equal(got, want)


def test_vt3_ila_vs_kernel_on_cpu():
    ok, worst = tfa.TARGET.vt3_checks["linear_ila_vs_af_gemm_kernel"](device="cpu")
    assert ok and worst == 0.0


def test_wrapper_refuses_unsupported_device():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        taf.af_gemm(x, x, torch.zeros((4,), device="meta"), 0.0, 0.0, 0.0)
