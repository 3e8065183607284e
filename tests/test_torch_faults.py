"""PyTorch port: the two faults ROADMAP Queue 3 listed for the port, repaired.

* ``kernels.ref.af_gemm_ref`` with a per-sample ``(B,)`` weight bias on a
  shared 2-D weight quantizes one copy of the weight per sample, each with
  its sample's bias, as the CUDA kernel does (it used to broadcast the bias
  over the weight's rows: wrong at B == N, an error otherwise). It equals
  the per-sample loop bit for bit, and per sample the JAX reference's
  ``repro.kernels.ref.af_gemm_ref`` (which takes the weight bias first, so
  it is called by keyword).
* ``core.cosim.train_app`` runs under ``device.deterministic()``: the same
  call gives the same parameters bit for bit, and the caller's determinism
  and cuDNN settings, and ``CUBLAS_WORKSPACE_CONFIG``, come back on return,
  also after an error.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import numerics as jn
from repro.kernels import ref as jref
from repro_torch import device as tdevice
from repro_torch.core import apps as tapps, cosim as tcosim
from repro_torch.kernels import ref as tref

J_SPEC = jn.AdaptivFloatSpec(8, 3)


def _per_sample_case(B, M, N, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, M, K)).astype(np.float32)
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((N,)) * 0.1).astype(np.float32)
    # biases that differ per sample, so a mix-up of samples and rows shows
    bx = rng.integers(-7, -3, B).astype(np.float32)
    bw = rng.integers(-9, -4, B).astype(np.float32)
    bo = rng.integers(-5, -1, B).astype(np.float32)
    assert len(set(bw.tolist())) > 1
    return x, w, b, bx, bw, bo


@pytest.mark.parametrize("B,M,N,K", [(4, 3, 4, 16), (3, 5, 7, 24), (5, 2, 3, 9)])
def test_af_gemm_ref_per_sample_weight_bias_on_shared_weight(B, M, N, K):
    """At B == N (once silently wrong) and B != N (once an error)."""
    x, w, b, bx, bw, bo = _per_sample_case(B, M, N, K, seed=B * N + K)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = tref.af_gemm_ref(tx, tw, tb, exp_bias_x=torch.from_numpy(bx),
                           exp_bias_w=torch.from_numpy(bw), exp_bias_o=torch.from_numpy(bo))
    assert got.shape == (B, M, N)
    for i in range(B):
        loop = tref.af_gemm_ref(tx[i], tw, tb, exp_bias_x=float(bx[i]),
                                exp_bias_w=float(bw[i]), exp_bias_o=float(bo[i]))
        jax_i = jref.af_gemm_ref(jnp.asarray(x[i]), jnp.asarray(w), jnp.asarray(b),
                                 exp_bias_w=float(bw[i]), exp_bias_x=float(bx[i]),
                                 exp_bias_o=float(bo[i]), spec=J_SPEC)
        np.testing.assert_array_equal(got[i].numpy(), loop.numpy())
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(jax_i))


def test_af_gemm_ref_scalar_weight_bias_keeps_one_weight():
    """A scalar or 0-d weight bias quantizes the shared weight once: the
    same bits as a per-sample bias that repeats that value."""
    x, w, b, bx, bw, bo = _per_sample_case(4, 3, 4, 16, seed=7)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    common = dict(exp_bias_x=torch.from_numpy(bx), exp_bias_o=torch.from_numpy(bo))
    scalar = tref.af_gemm_ref(tx, tw, tb, exp_bias_w=float(bw[0]), **common)
    zero_d = tref.af_gemm_ref(tx, tw, tb, exp_bias_w=torch.tensor(float(bw[0])), **common)
    repeated = tref.af_gemm_ref(tx, tw, tb, exp_bias_w=torch.full((4,), float(bw[0])), **common)
    assert torch.equal(scalar, zero_d) and torch.equal(scalar, repeated)


def _flags():
    cudnn = torch.backends.cudnn
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark)


def _set_flags(flags):
    torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[2], flags[3]


@pytest.fixture
def saved_flags():
    before = _flags()
    yield
    _set_flags(before)


def _small_app():
    builder = lambda seed=0: tapps.build_resmlp(seed=seed, layers=1)
    X, y = tcosim.make_teacher_task(builder, (16, 64), n=64, device="cpu")
    expr, params = builder()
    return expr, params, X, y


@pytest.mark.parametrize("flags", [(False, False, False, True), (False, False, True, False),
                                   (True, True, False, True)])
def test_train_app_restores_the_callers_settings(flags, saved_flags, monkeypatch):
    expr, params, X, y = _small_app()
    _set_flags(flags)
    inside = []
    real_grad = torch.func.grad

    def spy(fn):
        inside.append(_flags())
        return real_grad(fn)

    monkeypatch.setattr(torch.func, "grad", spy)
    tcosim.train_app(expr, params, X, y, steps=2, device="cpu")
    assert inside == [(True, False, True, False)]
    assert _flags() == flags


def test_deterministic_restores_after_an_error(saved_flags):
    flags = (False, False, False, True)
    _set_flags(flags)
    with pytest.raises(RuntimeError, match="inside"):
        with tdevice.deterministic():
            assert _flags() == (True, False, True, False)
            raise RuntimeError("inside")
    assert _flags() == flags


@pytest.mark.parametrize("preset", [None, ":16:8"])
def test_deterministic_sets_the_cublas_workspace_only_inside(preset, monkeypatch):
    """PyTorch's deterministic mode needs ``CUBLAS_WORKSPACE_CONFIG``; the
    block sets it when the caller has not, and leaves the caller's own."""
    name, value = tdevice.CUBLAS_WORKSPACE
    if preset is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, preset)
    with tdevice.deterministic():
        assert os.environ[name] == (preset or value)
    assert os.environ.get(name) == preset


@pytest.mark.parametrize("steps", [1, 12])
def test_two_trainings_give_equal_parameters(steps):
    expr, params, X, y = _small_app()
    first = tcosim.train_app(expr, params, X, y, steps=steps, lr=3e-3, device="cpu")
    second = tcosim.train_app(expr, params, X, y, steps=steps, lr=3e-3, device="cpu")
    assert set(first) == set(second) == set(params)
    for k in params:
        np.testing.assert_array_equal(first[k], second[k])
    assert any(not np.array_equal(first[k], params[k]) for k in params)
