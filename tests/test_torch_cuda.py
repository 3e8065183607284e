"""PyTorch port: the hand-written CUDA kernels on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one;
the file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each GEMM kernel (``af_gemm``, ``fx_gemm``, ``int8_gemm``) must equal its
plain PyTorch version bit for bit at the main path's shapes and at their
edges (M or N of 1, ragged K, per-sample biases, AF's flush and saturation
points and windows at the edges of the normal range, fixed-point operands
all at qmin or qmax), give the same bits on a second call, count exactly
one launch per call and refuse inputs it does not take; FlexASR's and VTA's ILA
simulators agree with their kernels (VT3, worst deviation 0.0), and the
HLSCNN fused engine (``fx_gemm``) is bit-identical to the compiled ILA on
the card and to the CPU. ``flash_attention`` sums in another order than its
plain version, so it is held to it within ``tests/test_kernels.py``'s
tolerances (fp32 2e-5, bf16 3e-2: a few bf16 rounding steps of outputs near
1) and, in bf16, within one bf16 step; bf16 goes to the wgmma design and
fp32 to the three-term wgmma design (``wgmma3``, at every head dim 1-256,
ragged S and Sk, any strides with a unit head-dim stride, also within 2e-5
of the plain version taken as that design sums), and a bf16 input the
wgmma design cannot take raises; both repeat bit for bit; the LM serving
path launches it once per layer in prefill and never in decode.
``int8_gemm`` is also checked at every K around its 32-deep k-steps and its
256-deep one-round-trip limit, at M = N = 1 and with operands of all -128.
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
#: (M, N, K) of af_gemm: tests/test_kernels.py, ResMLP in kernel mode, then
#: edges: M = 1, N = 1, K not a multiple of the 32-deep K tile nor of 4
KERNEL_MODE = [(64, 16, 16), (16, 128, 64), (16, 64, 128), (1, 10, 64)]
SHAPES = [(16, 32, 64), (128, 128, 128), (100, 50, 200), *KERNEL_MODE,
          (1, 1, 64), (1, 1, 5), (7, 1, 37), (1, 9, 130), (33, 70, 131), (40, 24, 97)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", KERNEL_MODE)
def test_af_gemm_per_sample_biases_equal_plain(m, n, k, cuda_device):
    """ResMLP's kernel-mode shapes in a batch of 3 with per-sample x, w and
    output biases (w shared, so the kernel quantizes one copy per sample)."""
    rng = np.random.default_rng(m * n + k)
    B = 3
    x = torch.from_numpy((rng.standard_normal((B, m, k)) * [[[0.1]], [[1.0]], [[8.0]]])
                         .astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy((rng.standard_normal((n,)) * 0.1).astype(np.float32)).to(cuda_device)
    bx = torch.stack([numerics.af_exp_bias(x[i], SPEC) for i in range(B)])
    bw = bx - 3
    bo = torch.stack([numerics.af_exp_bias(x[i] @ w.T + b, SPEC) for i in range(B)])
    got = kaf.af_gemm(x, w, b, bx, bw, bo)
    # the plain version quantizes the shared weight once per sample too: the
    # same as a weight repeated per sample
    assert torch.equal(got, ref.af_gemm_ref(x, w, b, bx, bw, bo))
    wb = w.expand(B, n, k).contiguous()
    assert torch.equal(got, ref.af_gemm_ref(x, wb, b, bx, bw, bo))
    # shared biases, then per-sample weights and biases
    assert torch.equal(kaf.af_gemm(x, w, b, -4.0, bw[0], bo[1]),
                       ref.af_gemm_ref(x, w, b, -4.0, bw[0], bo[1]))
    wb, bb = wb * 2, b.expand(B, n).contiguous()
    assert torch.equal(kaf.af_gemm(x, wb, bb, bx, bw, bo), ref.af_gemm_ref(x, wb, bb, bx, bw, bo))


def _straddle(bias: float, shape, rng) -> np.ndarray:
    """Values at and beside AF's flush threshold (vmin / 2) and saturation
    point (vmax) of the window at ``bias``, random signs."""
    e_lo, e_hi = bias, bias + 2 ** SPEC.n_exp - 1
    vmax = np.float32((2 - 2.0 ** -SPEC.n_man) * 2.0 ** e_hi)
    edges = []
    for v in (np.float32(2.0 ** e_lo / 2), np.float32(2.0 ** e_lo), vmax):
        edges += [v, np.nextafter(v, np.float32(0)), np.nextafter(v, np.float32(1e30))]
    edges += [vmax * 2, np.float32(2.0 ** e_lo / 4), 0.0]
    vals = rng.choice(np.asarray(edges, np.float32), size=shape)
    return (vals * rng.choice([-1, 1], size=shape)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(16, 64, 128), (2, 128, 128)])
def test_af_gemm_flush_and_saturation_edges_equal_plain(m, n, k, cuda_device):
    """x at and beside the flush threshold and the saturation point of its
    window; w of 0 and +-2^-3, +-2^-2, so every sum is exact in fp32 and
    the sum order cannot matter; an output window three binades below the
    sums' own, so the outputs both saturate and flush."""
    rng = np.random.default_rng(k + m)
    x = torch.from_numpy(_straddle(-6.0, (m, k), rng)).to(cuda_device)
    w = rng.choice([0.0, 0.125, -0.125, 0.25, -0.25], size=(n, k)).astype(np.float32)
    w = torch.from_numpy(w).to(cuda_device)
    b = torch.zeros(n, device=cuda_device)
    bo = numerics.af_exp_bias(x @ w.T, SPEC) - 3
    args = (x, w, b, -6.0, -7.0, bo)
    got = kaf.af_gemm(*args)
    want = ref.af_gemm_ref(*args)
    assert torch.equal(got, want)
    amax = (2 - 2.0 ** -SPEC.n_man) * 2.0 ** (float(bo) + 7)
    assert bool((want.abs() == amax).any()) and bool((want == 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [-127.0, -126.0, 119.0, 120.0])
def test_af_gemm_windows_at_the_normal_range_edges(bias, cuda_device):
    """Windows at and past the edges of the fast path's range [-126, 119]
    (past it, the kernel takes its wide quantizer): x and the output in
    the window at ``bias``, an identity weight so every sum is exact in any
    order, held to the plain version on the CPU."""
    rng = np.random.default_rng(int(bias) + 200)
    x = (rng.standard_normal((24, 32)) * 2.0 ** (bias + 4)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda_device)
    w = torch.eye(32, device=cuda_device)
    b = torch.zeros(32, device=cuda_device)
    args = (x, w, b, bias, -7.0, bias)
    got = kaf.af_gemm(*args)
    want = ref.af_gemm_ref(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    assert torch.equal(got.cpu(), want)
    assert bool((want != 0).any())


@pytest.mark.cuda
def test_af_gemm_repeats_bit_for_bit(cuda_device):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((8, 128, 128)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy((rng.standard_normal((256,)) * 0.1).astype(np.float32)).to(cuda_device)
    args = (x, w, b, torch.full((8,), -6.0, device=cuda_device), -10.0,
            torch.full((8,), -4.0, device=cuda_device))
    first = kaf.af_gemm(*args)
    assert torch.equal(first, kaf.af_gemm(*args))
    assert torch.equal(first, ref.af_gemm_ref(*args))


#: (B, M, N, K) of fx_gemm: the fused HLSCNN groups, then ragged shapes (B = 1,
#: and K = 801: a ragged last K slice on the 4-byte copy path)
FX_SHAPES = [(8, 144, 32, 800), (16, 144, 32, 800), (1, 7, 5, 3), (3, 33, 17, 70),
             (2, 144, 32, 75), (1, 144, 32, 800), (2, 144, 32, 801), (1, 5, 3, 801),
             (3, 40, 50, 9)]
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


#: fx_gemm's lattice extremes: every operand at qmin or at qmax (scaled past
#: the range, so the quantizer clamps), at the main path's K and at 4096
FX_EXTREMES = [(2, 20, 33, 800), (1, 16, 32, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("xs,ws", [(-1, -1), (1, -1), (1, 1)])
@pytest.mark.parametrize("B,M,N,K", FX_EXTREMES)
def test_fx_gemm_lattice_extremes_equal_plain(B, M, N, K, xs, ws, bits, cuda_device):
    wspec = numerics.HLSCNN_WEIGHT_UPDATED if bits == 16 else numerics.HLSCNN_WEIGHT_ORIGINAL
    act = numerics.HLSCNN_ACT
    x = torch.full((B, M, K), xs * 1e4, device=cuda_device)
    w = torch.full((N, K), ws * 1e4, device=cuda_device)
    # one column of mixed signs, so some sums cancel exactly
    w[0, ::2] *= -1
    got = kfx.fx_gemm(x, w, x_spec=act, w_spec=wspec, o_spec=act)
    assert torch.equal(got, ref.fx_gemm_ref(x, w, act, wspec, act))


@pytest.mark.cuda
def test_fx_gemm_refuses_operands_wider_than_16_bits(cuda_device):
    """The kernel splits each lattice integer into two bytes; a wider spec
    raises on the card (the plain version on the CPU takes it)."""
    x, w = _patches(1, 8, 4, 16, cuda_device)
    wide = numerics.FixedPointSpec(n_bits=17, n_frac=8)
    before = kfx.fx_gemm.launches
    with pytest.raises(ValueError, match="16 bits"):
        kfx.fx_gemm(x, w, x_spec=wide, w_spec=numerics.HLSCNN_WEIGHT_UPDATED,
                    o_spec=numerics.HLSCNN_ACT)
    assert kfx.fx_gemm.launches == before
    kfx.fx_gemm(x.cpu(), w.cpu(), x_spec=wide, w_spec=numerics.HLSCNN_WEIGHT_UPDATED,
                o_spec=numerics.HLSCNN_ACT)


@pytest.mark.cuda
def test_fx_gemm_repeats_bit_for_bit(cuda_device):
    x, w = _patches(16, 144, 32, 800, cuda_device, seed=11)
    specs = dict(x_spec=numerics.HLSCNN_ACT, w_spec=numerics.HLSCNN_WEIGHT_UPDATED,
                 o_spec=numerics.HLSCNN_ACT)
    first = kfx.fx_gemm(x, w, **specs)
    for _ in range(3):
        assert torch.equal(first, kfx.fx_gemm(x, w, **specs))


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


#: K around the kernel's 32-deep k-steps and its 256-deep one-round-trip limit
I8_EDGE_K = [1, 15, 16, 17, 31, 32, 33, 255, 256, 257]


@pytest.mark.cuda
@pytest.mark.parametrize("K", I8_EDGE_K)
def test_int8_gemm_edges_equal_plain(K, cuda_device):
    """At M = N = 1, at a ragged (5, 9) tile, and with both operands all
    -128 (the largest products, -128 * -128 = 2^14, summed K times); also on
    a view that starts one byte in, where the fragments load byte by byte."""
    rng = np.random.default_rng(K)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).to(cuda_device)

    cases = [(i8(1, K), i8(1, K)), (i8(5, K), i8(9, K))]
    full = torch.full((3, K), -128, dtype=torch.int8, device=cuda_device)
    cases.append((full, full[:2].contiguous()))
    flat = i8(5 * K + 1)
    cases.append((flat[1:].view(5, K), i8(9, K)))
    for a, b in cases:
        got = ki8.int8_gemm(a, b)
        assert torch.equal(got, ref.int8_gemm_ref(a, b)), (tuple(a.shape), tuple(b.shape))
        assert torch.equal(got.cpu(), a.cpu().int() @ b.cpu().int().T)
    assert int(ki8.int8_gemm(full, full)[0, 0]) == K * 2 ** 14


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(16, 64, 128), (200, 300, 600)])
def test_int8_gemm_repeats_bit_for_bit(M, N, K, cuda_device):
    rng = np.random.default_rng(M + K)
    a, b = (torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8)).to(cuda_device)
            for s in ((M, K), (N, K)))
    first = ki8.int8_gemm(a, b)
    for _ in range(3):
        assert torch.equal(first, ki8.int8_gemm(a, b))


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
#: cross-attention, Granite/Qwen3, Zamba2, Gemma and MLA (v padded to 192),
#: and two smoke-config head dims below the wgmma design's 64-column tile
#: (16, and 24 for DeepSeek's q/k); then TinyLlama's shape in bf16 with q
#: scaled by 8 (scores spread, so most of P lies far below 1, where the
#: split's mid and lo terms count)
FLASH_SHAPES = [
    (4, 32, 4, 1024, 1024, 64, True),
    (4, 32, 4, 1000, 1000, 64, True),
    (1, 8, 8, 1500, 1500, 64, False),
    (1, 8, 8, 32, 1500, 64, False),
    (1, 32, 8, 512, 512, 128, True),
    (1, 32, 32, 512, 512, 112, True),
    (1, 16, 16, 512, 512, 256, True),
    (1, 16, 16, 256, 256, 192, True),
    (2, 4, 2, 40, 40, 16, True),
    (2, 4, 4, 12, 100, 24, False),
]
#: tests/test_kernels.py's tolerances: fp32 sums in another order, and a few
#: bf16 steps of outputs near 1
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
#: bf16 also elementwise within 2e-5 + 2^-7 |want|: kernel and plain version
#: round the same fp32 function to nearest even, so they differ by at most
#: one bf16 step (2^-7 of |want| at most)
BF16_STEP = 2.0 ** -7


FLASH_CASES = [(*shape, dtype, 1.0) for shape in FLASH_SHAPES
               for dtype in (torch.bfloat16, torch.float32)]
FLASH_CASES.append((*FLASH_SHAPES[0], torch.bfloat16, 8.0))


def _qkv(B, Hq, Hkv, S, Sk, D, dtype, dev, seed=4, q_scale=1.0):
    """(B, S, H, D) tensors, as the models hold them."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    return [torch.from_numpy(a).to(dev, dtype) for a in (q * np.float32(q_scale), k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,causal,dtype,q_scale", FLASH_CASES)
def test_flash_attention_close_to_plain(B, Hq, Hkv, S, Sk, D, causal, dtype, q_scale,
                                        cuda_device):
    q, k, v = (t.transpose(1, 2)
               for t in _qkv(B, Hq, Hkv, S, Sk, D, dtype, cuda_device, q_scale=q_scale))
    before = kfa.flash_attention.launches
    by_design = dict(kfa.flash_attention.launches_by_design)
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert kfa.flash_attention.launches == before + 1
    design = "wgmma" if dtype == torch.bfloat16 else "wgmma3"
    by_design[design] += 1
    assert kfa.flash_attention.launches_by_design == by_design
    assert got.dtype == dtype and got.shape == (B, Hq, S, D)
    assert got.transpose(1, 2).is_contiguous()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_ATOL[dtype], rtol=0)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-5, rtol=BF16_STEP)
    # the same function on contiguous (B, H, S, D) copies
    again = kfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    assert torch.equal(got, again)


#: fp32 head dims of the three-term design: 1, ragged ones in each 64-column
#: chunk count (20, 112), and every padded head dim's own (64, 128, 192, 256)
FP32_HEAD_DIMS = [1, 20, 64, 112, 128, 192, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", FP32_HEAD_DIMS)
def test_flash_attention_fp32_design_at_every_head_dim(D, causal, cuda_device):
    """The wgmma3 design against the plain version (fp32 2e-5) and against
    the plain version taken as it sums (six pairs of bf16 terms), at ragged
    S and Sk with GQA; then on views that start 4 bytes in, which the bf16
    design's tensor maps would refuse and the fp32 design's scratch takes.
    Two calls give the same bits."""
    B, Hq, Hkv, S, Sk = 2, 6, 2, 77, 77 if causal else 131
    q, k, v = (t.transpose(1, 2) for t in _qkv(B, Hq, Hkv, S, Sk, D, torch.float32,
                                               cuda_device, seed=D))
    by_design = dict(kfa.flash_attention.launches_by_design)
    got = kfa.flash_attention(q, k, v, causal=causal)
    by_design["wgmma3"] += 1
    assert kfa.flash_attention.launches_by_design == by_design
    assert got.dtype == torch.float32 and got.shape == (B, Hq, S, D)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=FLASH_ATOL[torch.float32], rtol=0)
    split = ref.flash_attention_ref(q, k, v, causal=causal, split3=True)
    torch.testing.assert_close(got, split, atol=FLASH_ATOL[torch.float32], rtol=0)
    assert torch.equal(got, kfa.flash_attention(q, k, v, causal=causal))
    shifted = []
    for t in (q, k, v):
        flat = torch.empty(t.numel() + 1, device=cuda_device)
        view = flat[1:].view(B, t.shape[2], t.shape[1], D).transpose(1, 2)
        view.copy_(t)
        shifted.append(view)
    assert "16 bytes" in kfa.wgmma_refusal(*shifted)
    assert torch.equal(got, kfa.flash_attention(*shifted, causal=causal))


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
    # bf16 operands the wgmma design's tensor maps cannot take raise; they
    # are never handed to the fp32 design
    hb = torch.zeros((1, 8, 4, 20), dtype=torch.bfloat16, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="wgmma design refuses"):
        kfa.flash_attention(hb, hb[:, :2], hb[:, :2])
    flat = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:].view(1, 8, 4, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="storage offset"):
        kfa.flash_attention(shifted, shifted, shifted)
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "smollm_360m", "deepseek_v3_671b",
                                  "gemma_7b", "zamba2_7b", "whisper_base"])
def test_smoke_models_in_bf16_take_the_wgmma_design(arch, cuda_device):
    """bf16 smoke models on the card: every flash_attention call (prefill,
    Whisper's cross-attention in decode, the no-cache forward, which is
    where MLA calls it) is a wgmma launch, none is refused, and the logits
    stay finite."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import api

    cfg = get_smoke_config(arch)
    model = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(6)
    before = dict(kfa.flash_attention.launches_by_design)
    stats = {}
    if cfg.family == "audio":
        prompt = torch.from_numpy(rng.standard_normal(
            (2, api.AUDIO_ENC_FRAMES, cfg.d_model)).astype(np.float32)).to(cuda_device,
                                                                           torch.bfloat16)
        finite = True
    else:
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))).to(cuda_device)
        finite = bool(torch.isfinite(api.forward(cfg, model, prompt)).all())
    tokens = generate(cfg, model, prompt, 4, stats)
    torch.cuda.synchronize()
    after = kfa.flash_attention.launches_by_design
    assert tokens.shape == (2, 4) and stats["finite"] and finite
    assert after["wgmma3"] == before["wgmma3"]
    assert after["wgmma"] > before["wgmma"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_function_trains_through_the_kernel(dtype, cuda_device):
    """Training attention on the card: the autograd Function's forward is one
    kernel launch of the dtype's design (never the plain version), its output
    is the kernel's, and its gradient is autograd through the plain
    attention on the saved q, k, v (equal bit for bit)."""
    from repro_torch.models import layers as TL

    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype).requires_grad_(True)
               for shape in ((2, 96, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
    g_out = torch.randn((2, 96, 8, 64), generator=g, device=cuda_device).to(dtype)
    design = kfa.DESIGNS[dtype]
    before = dict(kfa.flash_attention.launches_by_design)
    out = TL.sdpa(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert kfa.flash_attention.launches_by_design[design] == before[design] + 1
    kernel = kfa.flash_attention(*(t.detach().transpose(1, 2) for t in (q, k, v)),
                                 causal=True).transpose(1, 2)
    assert torch.equal(out.detach(), kernel)
    got = torch.autograd.grad(out, (q, k, v), g_out)
    want = torch.autograd.grad(TL._attend(q, k, v, True, 64 ** -0.5), (q, k, v), g_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "smollm_360m", "deepseek_v3_671b",
                                  "zamba2_7b", "whisper_base", "falcon_mamba_7b"])
def test_smoke_train_step_on_the_card(arch, cuda_device):
    """One bf16 train step of each family on the card: every parameter gets a
    finite gradient (value_and_grad raises on a missing one), the loss and
    the new weights are finite, and with remat every attention of a block
    runs the wgmma kernel twice (forward and recompute); DeepSeek's MTP
    block, outside the remat'd stack, once."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.optimizers import tree_leaves

    cfg = get_smoke_config(arch)
    model = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    batch = steps.batch_to(SyntheticLM(cfg.vocab, 2, 32, seed=0).batch_at(0), cuda_device)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, 24, cfg.d_model), device=cuda_device).bfloat16()
    loss, grads = steps.value_and_grad(cfg, model, batch)
    assert torch.isfinite(loss) and all(bool(torch.isfinite(t).all()) for t in tree_leaves(grads))
    fn = steps.make_train_step(cfg, ShapeConfig("t", 32, 2, "train"), lr=1e-3, warmup=1,
                               total_steps=10)
    before = dict(kfa.flash_attention.launches_by_design)
    new, _state, metrics = fn(model, steps.optim.make_optimizer(
        steps.pick_optimizer(cfg)).init(model.tree()), batch, 1)
    torch.cuda.synchronize()
    launched = {d: kfa.flash_attention.launches_by_design[d] - before[d] for d in before}
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert all(bool(torch.isfinite(p).all()) for p in new.parameters())
    blocks = {"audio": cfg.n_enc_layers + 2 * cfg.n_dec_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(cfg.family, cfg.n_layers)
    assert launched == {"wgmma": 2 * blocks + (1 if cfg.mtp_depth else 0), "wgmma3": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_on_head_sharded_dtensors(dtype, cuda_device):
    """``layers.sdpa`` on DTensors over a 1x1 NCCL mesh, batch on 'data'
    and heads on 'model' (as ``hint_heads`` leaves them): the kernel runs
    on each rank's local shard and the result comes back with q's
    placements, equal to the plain-tensor call's output and gradients
    bit for bit, one kernel launch of the dtype's design per call."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch import mesh as rmesh
    from repro_torch.models import layers

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = rmesh.make_smoke_mesh(device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        q, k, v = (torch.randn((2, 64, h, 64), generator=gen, device=cuda_device).to(dtype)
                   for h in (8, 2, 2))
        placements = (Shard(0), Shard(2))
        dq, dk, dv = (distribute_tensor(t, mesh, placements).requires_grad_(True)
                      for t in (q, k, v))
        before = dict(kfa.flash_attention.launches_by_design)
        out = layers.sdpa(dq, dk, dv, causal=True)
        launched = {d: kfa.flash_attention.launches_by_design[d] - before[d] for d in before}
        assert tuple(out.placements) == placements
        assert launched[kfa.DESIGNS[dtype]] == 1 and sum(launched.values()) == 1
        pq, pk, pv = (t.clone().requires_grad_(True) for t in (q, k, v))
        want = layers.sdpa(pq, pk, pv, causal=True)
        assert torch.equal(out.full_tensor(), want)
        grad = torch.randn(want.shape, generator=gen, device=cuda_device).to(dtype)
        out.backward(distribute_tensor(grad, mesh, placements))
        want.backward(grad)
        for a, b in ((dq, pq), (dk, pk), (dv, pv)):
            assert torch.equal(a.grad.full_tensor(), b.grad)
    finally:
        dist.destroy_process_group()
