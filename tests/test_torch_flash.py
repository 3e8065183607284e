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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as kfa, ops as tops, ref as tref
from repro_torch.models import layers as TL

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
