"""PyTorch port: flash_attention's plain version against the JAX reference.

On CPU tensors the port's ``flash_attention`` wrapper runs its plain version
(``repro_torch.kernels.ref.flash_attention_ref``), which the card's kernel
is held to in ``tests/test_torch_cuda.py``. Here that function meets:

* the JAX Pallas kernel, run as ``tests/test_kernels.py`` runs it (interpret
  mode through ``repro.kernels.ops``), causal and not, GQA 4/2 and 15/5, in
  fp32 at ``atol 2e-5`` (``tests/test_kernels.py:69``: both sum the same
  fp32 products in another order). Only block-multiple S and Sk, and causal
  only at S == Sk, because of the two reference faults in ROADMAP Queue 3
  (padded keys unmasked when not causal; a bottom-right causal mask in the
  oracle);
* the reference's oracle ``repro.kernels.ref.flash_attention_ref`` on
  repeated KV heads;
* at ragged Sk, the reference's dense attention over exactly the real keys:
  the port masks the keys the Pallas wrapper pads;
* the models' ``sdpa`` layout (B, S, H, D) against ``repro.models.layers.sdpa``,
  its dense and chunked paths, and MLA's narrower v.

For the card's wgmma design (bf16): its split of P into three bf16 terms
(``ref.bf16x3_split``) sums to P bit for bit; the plain version with P.V
taken as the three terms' products still meets the Pallas kernel at
``atol 2e-5``; and every bf16 call the ten configs' smoke models make meets
the design's preconditions (``wgmma_refusal``), so none would be refused on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as kfa, ops as tops, ref as tref
from repro_torch.models import api as tapi, layers as TL

#: fp32 sums of the same products in another order (tests/test_kernels.py:69)
ATOL = 2e-5


def _qkv(B, Hq, Hkv, S, Sk, D, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, dv or D)).astype(np.float32))


def _port(q, k, v, causal):
    out = kfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    return out.numpy()


@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,causal", [
    (1, 4, 4, 128, 128, 64, True),
    (1, 4, 4, 128, 128, 64, False),
    (2, 4, 2, 256, 256, 32, True),
    (2, 4, 2, 128, 384, 32, False),
    (1, 15, 5, 128, 128, 64, True),
    (1, 15, 5, 256, 128, 16, False),
])
def test_plain_matches_pallas_interpret(B, Hq, Hkv, S, Sk, D, causal):
    q, k, v = _qkv(B, Hq, Hkv, S, Sk, D, seed=S + Sk + Hq)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (15, 5), (3, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_oracle_on_repeated_kv(Hq, Hkv, causal):
    q, k, v = _qkv(2, Hq, Hkv, 48, 48, 20, seed=Hq)
    g = Hq // Hkv
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=1)),
                                    jnp.asarray(np.repeat(v, g, axis=1)), causal=causal)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("S,Sk", [(1, 77), (32, 1500), (100, 131)])
def test_ragged_keys_get_no_weight(S, Sk):
    """Not causal at a ragged Sk: the port equals the reference's dense
    attention over the Sk real keys, which is the Pallas kernel's function
    with its padded keys masked."""
    q, k, v = _qkv(1, 4, 2, S, Sk, 16, seed=Sk)
    tr = (0, 2, 1, 3)   # (B, H, S, D) <-> (B, S, H, D)
    want = JL._sdpa_dense(jnp.asarray(q.transpose(tr)), jnp.asarray(k.transpose(tr)),
                          jnp.asarray(v.transpose(tr)), causal=False)
    got = _port(q, k, v, causal=False)
    np.testing.assert_allclose(got, np.asarray(want).transpose(tr), atol=ATOL, rtol=0)


@pytest.mark.parametrize("S,H,Hkv,D,dv,causal", [
    (64, 4, 2, 16, 16, True),       # dense path
    (40, 3, 1, 20, 20, False),      # dense, smollm's GQA 3/1
    (3072, 2, 2, 16, 16, True),     # chunked path (Sk > CHUNK_THRESHOLD)
    (24, 4, 4, 24, 16, True),       # MLA: v narrower than q/k, zero-padded
])
def test_model_sdpa_matches_reference(S, H, Hkv, D, dv, causal):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, H, D)).astype(np.float32)
    k = rng.standard_normal((2, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((2, S, Hkv, dv)).astype(np.float32)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = TL.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.shape == (2, S, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bf16_plain_matches_pallas_interpret():
    """bf16 inputs: both upcast to fp32 and round the output once to bf16;
    held at tests/test_kernels.py:80's 3e-2 (a few bf16 steps of values near 1)."""
    q, k, v = _qkv(1, 2, 1, 128, 128, 64, seed=9)
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = kfa.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_plain_version_semantics():
    """Top-left causal mask, finite mask value, output in q's dtype, and
    the ops re-export is the wrapper itself."""
    assert tops.flash_attention is kfa.flash_attention
    assert tref.NEG_INF == -1e30
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 3, 5, 4, seed=1))
    out = tref.flash_attention_ref(q, k, v, causal=True)
    # row 0 attends to key 0 only (top-left alignment), whatever Sk is
    torch.testing.assert_close(out[:, :, 0], v[:, :, 0], atol=1e-6, rtol=0)
    assert torch.isfinite(out).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 4, 300))
    with pytest.raises(ValueError, match="head dim"):
        kfa.flash_attention(q, q, q)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3, 2, 4, 4, 8))
    with pytest.raises(ValueError, match="shapes"):
        kfa.flash_attention(q, k, v)
    before = kfa.flash_attention.launches
    kfa.flash_attention(q[:, :2], k, v)
    assert kfa.flash_attention.launches == before   # the plain version counts nothing


def _split_exact(p):
    """bf16x3_split of fp32 numpy ``p``: (terms, each term bf16, sum == p)."""
    terms = tref.bf16x3_split(torch.from_numpy(p))
    in_bf16 = all(torch.equal(t, t.bfloat16().float()) for t in terms)
    total = terms[0] + terms[1] + terms[2]
    return terms, in_bf16, total


def test_bf16x3_split_sums_to_p_bit_for_bit():
    """hi + mid + lo == p in fp32 and each term is a bf16 value, for p in
    (0, 1] (what the kernel splits): seeded p, 1.0, every power of two down
    to 2^-120, the values just below them and seeded mantissas at every
    exponent down to 2^-110; below that (weights under 2^-110 of the row's
    largest), lo falls on bf16's subnormal grid, within 2^-134 of p."""
    rng = np.random.default_rng(14)
    f32 = np.float32
    e = np.arange(-120, 1)
    pow2 = np.ldexp(f32(1), e).astype(f32)
    below = np.nextafter(pow2, f32(0))
    seeded = (1 - rng.random(100_000, dtype=f32)).astype(f32)
    deep = ((1 + rng.random(50_000)) * np.ldexp(1.0, rng.integers(-110, 0, 50_000))).astype(f32)
    p = np.concatenate([seeded, [f32(1)], pow2, below[e >= -109], deep])
    assert p.min() >= 2.0 ** -120 and p.max() == 1.0
    (hi, mid, lo), in_bf16, total = _split_exact(p)
    assert in_bf16
    assert torch.equal(total, torch.from_numpy(p))
    assert torch.equal(hi, torch.from_numpy(p).bfloat16().float())
    tiny = np.concatenate([below[e < -109], ((1 + rng.random(10_000)) * np.ldexp(
        1.0, rng.integers(-120, -110, 10_000))).astype(f32)])
    _, in_bf16, total = _split_exact(tiny)
    assert in_bf16
    assert float((total.double() - torch.from_numpy(tiny).double()).abs().max()) <= 2.0 ** -134


@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,causal", [
    (1, 4, 4, 128, 128, 64, True),
    (2, 4, 2, 256, 256, 32, True),
    (1, 15, 5, 128, 256, 64, False),
])
def test_split_pv_plain_matches_pallas_interpret(B, Hq, Hkv, S, Sk, D, causal):
    """P.V as the wgmma design takes it, the three bf16 terms' products
    summed in fp32, on bf16-valued inputs (the kernel's): still the Pallas
    kernel's function at atol 2e-5."""
    q, k, v = (np.asarray(torch.from_numpy(a).bfloat16().float())
               for a in _qkv(B, Hq, Hkv, S, Sk, D, seed=S + Sk + Hq + 1))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                   pv_split=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_scale_is_passed_through():
    """An explicit scale (the models' padded head dims keep 1/sqrt(Dh))
    equals the default at 1/sqrt(D) and scales the scores otherwise."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 16, 16, 8, seed=3))
    torch.testing.assert_close(kfa.flash_attention(q, k, v, scale=8 ** -0.5),
                               kfa.flash_attention(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(kfa.flash_attention(q, k, v, scale=0.25),
                               tref.flash_attention_ref(q * 0.25 * 8 ** 0.5, k, v),
                               rtol=0, atol=1e-6)


def test_wgmma_refusal_names_each_precondition():
    ok = [torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16).transpose(1, 2) for _ in range(3)]
    assert kfa.wgmma_refusal(*ok) is None
    q = torch.zeros((2, 4, 3, 20), dtype=torch.bfloat16).transpose(1, 2)  # rows of 40 bytes
    assert "16 bytes" in kfa.wgmma_refusal(q, q, q)
    flat = torch.zeros(2 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 8, 4, 64).transpose(1, 2)      # starts 2 bytes in
    assert "storage offset 1" in kfa.wgmma_refusal(shifted, ok[1], ok[2])
    big = torch.zeros((1, 1, 4, 320), dtype=torch.bfloat16)
    assert "head dim" in kfa.wgmma_refusal(big, big, big)
    assert "unit head-dim stride" in kfa.wgmma_refusal(ok[0][..., ::2], ok[1], ok[2])
    one = torch.zeros((1, 3, 1, 24), dtype=torch.bfloat16)   # extent-1 dims are never stepped
    assert kfa.wgmma_refusal(one.transpose(1, 2), one.transpose(1, 2), one.transpose(1, 2)) is None


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_model_calls_meet_wgmma_preconditions(arch, monkeypatch):
    """Every flash_attention call of a smoke model in bf16 (prefill, decode
    steps, where Whisper's cross-attention calls it, and the no-cache
    forward) would be taken by the wgmma design on the card."""
    calls = []
    real = tops.flash_attention

    def record(q, k, v, **kw):
        calls.append((tuple(q.shape), kfa.wgmma_refusal(q, k, v)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tops, "flash_attention", record)
    cfg = tconfigs.get_smoke_config(arch)
    model = tapi.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
    cache = tapi.init_cache(cfg, 2, 8, dtype=torch.bfloat16, device="cpu")
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (2, tapi.AUDIO_ENC_FRAMES, cfg.d_model)).astype(np.float32)).bfloat16()
        _, cache = tapi.prefill(cfg, model, frames, cache)
        start = 0
    else:
        _, cache = tapi.prefill(cfg, model, toks[:, :5], cache)
        tapi.forward(cfg, model, toks)
        start = 5
    for i in range(2):
        tapi.decode_step(cfg, model, cache, toks[:, i:i + 1], start + i)
    refused = [(shape, why) for shape, why in calls if why is not None]
    assert not refused, refused
    if cfg.family != "ssm":
        assert calls


#: (B, Hq, Hkv, S, Sk, D, causal): GQA, causal, ragged S and Sk, head dims
#: below and across the design's 64-column chunks
SPLIT3_SHAPES = [
    (2, 4, 2, 48, 48, 20, True),
    (1, 6, 2, 37, 37, 64, True),
    (1, 4, 1, 33, 100, 24, False),
    (2, 3, 3, 70, 70, 112, True),
    (1, 2, 2, 17, 129, 256, False),
]


@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,causal", SPLIT3_SHAPES)
def test_split3_plain_matches_fp32_plain_and_reference(B, Hq, Hkv, S, Sk, D, causal):
    """The fp32 wgmma design's function (q, k, v and P as three bf16 terms,
    six pairs of terms in each product) against the fp32 plain version and
    the reference's oracle on repeated KV heads, at atol 2e-5; the oracle's
    causal mask is bottom-right, so it is compared causal only at S == Sk."""
    q, k, v = _qkv(B, Hq, Hkv, S, Sk, D, seed=S + Sk + D)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, split3=True)
    plain = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    if causal:
        assert S == Sk
    g = Hq // Hkv
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=1)),
                                    jnp.asarray(np.repeat(v, g, axis=1)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_dropped_term_pairs_stay_under_2_to_the_minus_24(scale):
    """The three pairs the fp32 design drops (mid.lo, lo.mid, lo.lo) each
    weigh at most 2^-24 |a||b|, elementwise, on seeded fp32 values; over a
    dot product the six kept pairs then differ from the exact float64 sum by
    at most 3 * 2^-24 of the sum of |a||b| (the terms are exact)."""
    rng = np.random.default_rng(int(scale * 7) + 3)
    a = (rng.standard_normal((64, 96)) * scale).astype(np.float32)
    b = (rng.standard_normal((80, 96)) * scale).astype(np.float32)
    ta, tb = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    at = [t.double() for t in tref.bf16x3_split(torch.from_numpy(a))]
    bt = [t.double() for t in tref.bf16x3_split(torch.from_numpy(b))]
    assert torch.equal(at[0] + at[1] + at[2], ta) and torch.equal(bt[0] + bt[1] + bt[2], tb)
    bound = 2.0 ** -24
    for t, full in ((at, ta), (bt, tb)):
        assert bool((t[1].abs() <= 2.0 ** -8 * full.abs()).all())
        assert bool((t[2].abs() <= 2.0 ** -16 * full.abs()).all())
    mag = ta.abs()[:, None, :] * tb.abs()[None, :, :]
    for i, j in ((1, 2), (2, 1), (2, 2)):
        assert (i, j) not in tref.TERM_PAIRS
        prod = (at[i][:, None, :] * bt[j][None, :, :]).abs()
        assert bool((prod <= bound * mag).all()), (i, j)
    kept = sum(at[i] @ bt[j].mT for i, j in tref.TERM_PAIRS)
    assert bool(((kept - ta @ tb.mT).abs() <= 3 * bound * mag.sum(-1)).all())
