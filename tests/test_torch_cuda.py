"""PyTorch port: the hand-written CUDA kernels on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one;
the file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each GEMM kernel (``af_gemm``, ``fx_gemm``, ``int8_gemm``) must equal its
plain PyTorch version bit for bit at the main path's shapes, count exactly
its own launches and refuse inputs it does not take; FlexASR's and VTA's ILA
simulators agree with their kernels (VT3, worst deviation 0.0), and the
HLSCNN fused engine (``fx_gemm``) is bit-identical to the compiled ILA on
the card and to the CPU. ``flash_attention`` sums in another order than its
plain version, so it is held to it within ``tests/test_kernels.py``'s
tolerances (fp32 2e-5, bf16 3e-2: a few bf16 rounding steps of outputs near
1); the LM serving path launches it once per layer in prefill and never in
decode, and its prefill logits on the card match the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.accel import flexasr as fa, hlscnn as hl, numerics, vta
from repro_torch.core import ir
from repro_torch.core.codegen import Executor
from repro_torch.kernels import (
    af_gemm as kaf, flash_attention as kfa, fx_gemm as kfx, int8_gemm as ki8, ref,
)

SPEC = numerics.AdaptivFloatSpec(8, 3)
SHAPES = [(16, 32, 64), (128, 128, 128), (100, 50, 200),
          (64, 16, 16), (16, 128, 64), (16, 64, 128), (1, 10, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
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


#: (B, M, N, K) of fx_gemm: the fused HLSCNN groups, then ragged shapes
FX_SHAPES = [(8, 144, 32, 800), (16, 144, 32, 800), (1, 7, 5, 3), (3, 33, 17, 70),
             (2, 144, 32, 75)]
#: (M, N, K) of int8_gemm: ResMLP on VTA in kernel mode, then tests/test_kernels.py
I8_SHAPES = [(64, 16, 16), (16, 128, 64), (16, 64, 128), (1, 10, 64),
             (1, 3, 7), (128, 128, 128), (200, 300, 150)]


def _patches(B, M, N, K, dev, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, M, K)) * 4).astype(np.float32)
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("B,M,N,K", FX_SHAPES)
def test_fx_gemm_equals_plain(B, M, N, K, bits, cuda_device):
    x, w = _patches(B, M, N, K, cuda_device)
    wspec = numerics.HLSCNN_WEIGHT_UPDATED if bits == 16 else numerics.HLSCNN_WEIGHT_ORIGINAL
    specs = dict(x_spec=numerics.HLSCNN_ACT, w_spec=wspec, o_spec=numerics.HLSCNN_ACT)
    before = kfx.fx_gemm.launches
    got = kfx.fx_gemm(x, w, **specs)
    assert kfx.fx_gemm.launches == before + 1
    want = ref.fx_gemm_ref(x, w, specs["x_spec"], wspec, specs["o_spec"])
    assert torch.equal(got, want)
    assert torch.equal(got, kfx.fx_gemm(x.cpu(), w.cpu(), **specs).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", I8_SHAPES)
def test_int8_gemm_equals_plain(M, N, K, cuda_device):
    rng = np.random.default_rng(M * N + K)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(cuda_device)
    b = torch.from_numpy(rng.integers(-128, 128, (N, K)).astype(np.int8)).to(cuda_device)
    before = ki8.int8_gemm.launches
    got = ki8.int8_gemm(a, b)
    assert ki8.int8_gemm.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.int8_gemm_ref(a, b))
    assert torch.equal(got.cpu(), a.cpu().int() @ b.cpu().int().T)


@pytest.mark.cuda
def test_vta_vt3_ila_vs_kernel_on_card(cuda_device):
    ok, worst = vta.TARGET.vt3_checks["gemm_ila_vs_int8_gemm_kernel"](device=cuda_device)
    assert ok and worst == 0.0


@pytest.mark.cuda
def test_fx_and_int8_gemm_reject_bad_inputs(cuda_device):
    before = kfx.fx_gemm.launches, ki8.int8_gemm.launches
    x, w = _patches(1, 8, 4, 16, cuda_device)
    specs = dict(x_spec=numerics.HLSCNN_ACT, w_spec=numerics.HLSCNN_WEIGHT_UPDATED,
                 o_spec=numerics.HLSCNN_ACT)
    with pytest.raises(TypeError):
        kfx.fx_gemm(x.double(), w, **specs)
    with pytest.raises(ValueError):
        kfx.fx_gemm(x, w[:, :8].contiguous(), **specs)
    with pytest.raises(ValueError):
        kfx.fx_gemm(x[0].t(), w, **specs)
    with pytest.raises(ValueError, match="exact"):
        kfx.fx_gemm(torch.zeros((2, 2 ** 23), device=cuda_device),
                    torch.zeros((2, 2 ** 23), device=cuda_device), **specs)
    a = torch.zeros((4, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError):
        ki8.int8_gemm(a.int(), a)
    with pytest.raises(ValueError):
        ki8.int8_gemm(a, a[:, :4].contiguous())
    with pytest.raises(ValueError):
        ki8.int8_gemm(a.t(), a)
    assert (kfx.fx_gemm.launches, ki8.int8_gemm.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_hlscnn_fused_engine_bit_identical_on_card(bits, cuda_device):
    """The fused conv runner (one fx_gemm launch per group) equals the
    compiled ILA on the card, and both equal the CPU run."""
    rng = np.random.default_rng(bits)
    xs = [rng.standard_normal((1, 12, 12, 8)).astype(np.float32) for _ in range(3)]
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.1).astype(np.float32)
    e = ir.call("hlscnn_conv2d", ir.Var("x", (1, 12, 12, 8)), ir.Var("w", w.shape),
                strides=(1, 1), padding=(1, 1))
    envs = [{"x": x, "w": w} for x in xs]
    opts = {"hlscnn": {"wgt_bits": bits}}
    outs = {}
    for dev in (cuda_device, "cpu"):
        for engine in ("compiled", "fused"):
            ex = Executor("ila", engine=engine, target_options=opts, device=dev)
            before = kfx.fx_gemm.launches
            outs[(str(dev), engine)] = [np.asarray(o) for o in ex.run_many(e, envs)]
            launched = kfx.fx_gemm.launches - before
            assert launched == (1 if (engine == "fused" and str(dev) != "cpu") else 0)
    ref_out = outs[("cpu", "compiled")]
    for key, got in outs.items():
        for g, r in zip(got, ref_out):
            np.testing.assert_array_equal(g, r, err_msg=str(key))
    assert hl.TARGET.fused_runner(hl.conv2d_fragment(w, (14, 14, 8), wgt_bits=bits),
                                  cuda_device).lowering == "kernel"


#: (B, Hq, Hkv, S, Sk, D, causal) of flash_attention, each in bf16 and fp32:
#: TinyLlama prefill, a ragged prompt, the Whisper encoder and
#: cross-attention, Granite/Qwen3, Zamba2, Gemma and MLA (v padded to 192)
FLASH_SHAPES = [
    (4, 32, 4, 1024, 1024, 64, True),
    (4, 32, 4, 1000, 1000, 64, True),
    (1, 8, 8, 1500, 1500, 64, False),
    (1, 8, 8, 32, 1500, 64, False),
    (1, 32, 8, 512, 512, 128, True),
    (1, 32, 32, 512, 512, 112, True),
    (1, 16, 16, 512, 512, 256, True),
    (1, 16, 16, 256, 256, 192, True),
]
#: tests/test_kernels.py's tolerances: fp32 sums in another order, and a few
#: bf16 steps of outputs near 1
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
#: bf16 also elementwise within 2e-5 + 2^-7 |want|: kernel and plain version
#: round the same fp32 function to nearest even, so they differ by at most
#: one bf16 step (2^-7 of |want| at most)
BF16_STEP = 2.0 ** -7


def _qkv(B, Hq, Hkv, S, Sk, D, dtype, dev, seed=4):
    """(B, S, H, D) tensors, as the models hold them."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((B, S, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,causal", FLASH_SHAPES)
def test_flash_attention_close_to_plain(B, Hq, Hkv, S, Sk, D, causal, dtype, cuda_device):
    q, k, v = (t.transpose(1, 2) for t in _qkv(B, Hq, Hkv, S, Sk, D, dtype, cuda_device))
    before = kfa.flash_attention.launches
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert kfa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, Hq, S, D)
    assert got.transpose(1, 2).is_contiguous()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_ATOL[dtype], rtol=0)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-5, rtol=BF16_STEP)
    # the same function on contiguous (B, H, S, D) copies
    again = kfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs(cuda_device):
    q, k, v = (t.transpose(1, 2) for t in _qkv(1, 4, 2, 8, 8, 16, torch.float32, cuda_device))
    before = kfa.flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 2, 8, 320), device=cuda_device)
        kfa.flash_attention(big, big, big)
    with pytest.raises(ValueError):
        kfa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="unit head-dim stride"):
        kfa.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(TypeError):
        kfa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        kfa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        kfa.flash_attention(q, k[:, :1], v)
    assert kfa.flash_attention.launches == before


@pytest.mark.cuda
def test_lm_generate_launches_kernel_once_per_layer_in_prefill(cuda_device):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import api

    cfg = get_smoke_config("tinyllama_1_1b")
    model = api.init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                            dtype=torch.float32).to(cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 40)))
    stats = {}
    tokens = generate(cfg, model, prompt.to(cuda_device), 6, stats)
    assert tokens.shape == (2, 6) and stats["finite"]
    assert (stats["prefill_launches"], stats["decode_launches"]) == (cfg.n_layers, 0)
