"""PyTorch port: the hand-written CUDA kernels on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one;
the file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``af_gemm`` must equal its plain PyTorch version bit for bit at the main
path's shapes, count exactly its own launches, and agree with the FlexASR
ILA simulator (VT3, worst deviation 0.0).
"""
import numpy as np
import pytest
import torch

from repro_torch.accel import flexasr as fa, numerics
from repro_torch.kernels import af_gemm as kaf, ref

SPEC = numerics.AdaptivFloatSpec(8, 3)
SHAPES = [(16, 32, 64), (128, 128, 128), (100, 50, 200),
          (64, 16, 16), (16, 128, 64), (16, 64, 128), (1, 10, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the af_gemm kernel has no CPU mode")
    return torch.device("cuda")


def _linear(m, n, k, dev, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((n,)) * 0.1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, w, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_af_gemm_equals_plain(m, n, k, cuda_device):
    x, w, b = _linear(m, n, k, cuda_device)
    bx, bw = numerics.af_exp_bias(x, SPEC), numerics.af_exp_bias(w, SPEC)
    bo = numerics.af_exp_bias(x @ w.T + b, SPEC)
    before = kaf.af_gemm.launches
    got = kaf.af_gemm(x, w, b, bx, bw, bo)
    assert kaf.af_gemm.launches == before + 1
    want = ref.af_gemm_ref(x, w, b, bx, bw, bo)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_af_gemm_fused_batch_equals_plain(cuda_device):
    rng = np.random.default_rng(2)
    B = 16
    x = torch.from_numpy(rng.standard_normal((B, 128, 128)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy((rng.standard_normal((256,)) * 0.1).astype(np.float32)).to(cuda_device)
    ba = torch.from_numpy(rng.integers(-7, -4, B).astype(np.float32)).to(cuda_device)
    bo = torch.from_numpy(rng.integers(-5, -2, B).astype(np.float32)).to(cuda_device)
    bw = float(numerics.af_exp_bias(w, SPEC))
    got = kaf.af_gemm(x, w, b, ba, bw, bo)
    assert torch.equal(got, ref.af_gemm_ref(x, w, b, ba, bw, bo))


@pytest.mark.cuda
def test_vt3_ila_vs_kernel_on_card(cuda_device):
    ok, worst = fa.TARGET.vt3_checks["linear_ila_vs_af_gemm_kernel"](device=cuda_device)
    assert ok and worst == 0.0


@pytest.mark.cuda
def test_af_gemm_rejects_bad_inputs(cuda_device):
    x, w, b = _linear(8, 4, 16, cuda_device)
    with pytest.raises(TypeError):
        kaf.af_gemm(x.double(), w, b, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError):
        kaf.af_gemm(x, w[:, :8].contiguous(), b, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError):
        kaf.af_gemm(x.t(), w, b, 0.0, 0.0, 0.0)
