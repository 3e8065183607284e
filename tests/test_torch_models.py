"""PyTorch port: the ten model configs against the JAX reference.

For each of ``ARCH_IDS`` at its ``smoke_config()``, the reference's fp32
weights (``repro.models.api.init_params``) go into the port through
``params_from_numpy``, and both packages run the same seeded numpy tokens:

* prefill, then teacher-forced ``decode_step``, logits at every step;
* the training-style ``forward`` (the reference without remat); Whisper's
  encoder and cross-attention instead;

all at ``rtol = atol = 1e-4`` in fp32 (the bound ``tests/test_models.py``
uses for prefill against forward: both packages compute the same fp32
function, summing in other orders). MoE runs at the default
``capacity_factor``, so the same tokens must be dropped: the port sorts
with a stable argsort, as ``jnp.argsort`` does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi, layers as JL, lm as jlm, ssm as jssm, whisper as jwhisper
from repro_torch import configs as tconfigs
from repro_torch.models import (
    api as tapi, layers as TL, ssm as tssm, whisper as twhisper,
)

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, TOTAL = 2, 5, 8


def _pair(arch, seed=0):
    """The reference's smoke config and fp32 params, and the port's model
    on the same weights."""
    cfg = jconfigs.get_smoke_config(arch)
    params = japi.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    model = tapi.params_from_numpy(tconfigs.get_smoke_config(arch),
                                   jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return cfg, params, model


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(kw or TOL))


def test_configs_are_copied_verbatim():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS and tconfigs.DASHED == jconfigs.DASHED
    for arch in jconfigs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            want = getattr(jconfigs, get)(arch)
            got = getattr(tconfigs, get)(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, get)
            assert type(got).__module__ == "repro_torch.models.config"
    got = tconfigs.get_config("tinyllama-1.1b")
    assert (got.n_layers, got.d_model, got.n_heads, got.n_kv_heads, got.hd, got.vocab) == \
        (22, 2048, 32, 4, 64, 32000)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    cfg, params, model = _pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, TOTAL))
    jc = japi.init_cache(cfg, B, TOTAL, dtype=jnp.float32)
    tc = tapi.init_cache(model.cfg, B, TOTAL, dtype=torch.float32, device="cpu")
    if cfg.family == "audio":
        frames = rng.standard_normal((B, japi.AUDIO_ENC_FRAMES, cfg.d_model)).astype(np.float32)
        jl, jc = japi.prefill(cfg, params, jnp.asarray(frames), jc)
        tl, tc = tapi.prefill(model.cfg, model, torch.from_numpy(frames), tc)
        start = 0
    else:
        jl, jc = japi.prefill(cfg, params, jnp.asarray(toks[:, :PROMPT], jnp.int32), jc)
        tl, tc = tapi.prefill(model.cfg, model, torch.from_numpy(toks[:, :PROMPT]), tc)
        start = PROMPT
    assert tl.shape == (B, 1, cfg.vocab)
    _close(tl, jl)
    for t in range(start, TOTAL):
        jl, jc = japi.decode_step(cfg, params, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32), t)
        tl, tc = tapi.decode_step(model.cfg, model, tc, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl, jl)
    # the in-place cache holds what the reference's functional update returns
    for path, want in jax.tree_util.tree_flatten_with_path(jc)[0]:
        got = tc
        for key in path:
            got = got[key.key]
        _close(got, want)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_forward_matches_reference(arch):
    cfg, params, model = _pair(arch, seed=1)
    rng = np.random.default_rng(2)
    if cfg.family == "audio":
        frames = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
        enc = jwhisper.encode(cfg, params, jnp.asarray(frames))
        got = twhisper.encode(model.cfg, model, torch.from_numpy(frames))
        _close(got, enc)
        x = rng.standard_normal((B, 6, cfg.d_model)).astype(np.float32)
        lp = jax.tree_util.tree_map(lambda a: a[0], params["dec_layers"])
        want = jwhisper._cross_attention(cfg, lp["cross_attn"], jnp.asarray(x), enc)
        got = twhisper._cross_attention(model.cfg, model["dec_layers"][0]["cross_attn"],
                                        torch.from_numpy(x), got)
        _close(got, want)
        with pytest.raises(ValueError):
            tapi.forward(model.cfg, model, torch.zeros((B, 4), dtype=torch.long))
        return
    toks = rng.integers(0, cfg.vocab, (B, TOTAL))
    want = jlm.forward(cfg, params, jnp.asarray(toks, jnp.int32), remat=False)
    got = tapi.forward(model.cfg, model, torch.from_numpy(toks))
    assert got.shape == (B, TOTAL, cfg.vocab)
    _close(got, want)


def test_moe_drops_the_same_tokens():
    """More tokens than the capacity: some expert overflows, and the port
    drops the same (token, expert) pairs as the reference."""
    cfg = jconfigs.get_smoke_config("qwen3_moe_30b_a3b")
    p = JL.moe_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal((96, cfg.d_model)).astype(np.float32)
    scores = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    counts = np.bincount(np.asarray(jax.lax.top_k(scores, cfg.top_k)[1]).ravel(),
                         minlength=cfg.n_experts)
    capacity = max(8, int(cfg.capacity_factor * x.shape[0] * cfg.top_k / cfg.n_experts))
    assert counts.max() > capacity, (counts, capacity)
    want = JL._moe_group(cfg, p, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    _close(TL._moe_group(tconfigs.get_smoke_config("qwen3_moe_30b_a3b"), tp,
                         torch.from_numpy(x)), want)


def test_ssm_scans_match_reference():
    """Mamba1's step loop across the reference's remat chunk boundary
    (S = 512, two chunks) with a carried state, and Mamba2's SSD form."""
    cfg = jconfigs.get_smoke_config("falcon_mamba_7b")
    p = jssm.mamba1_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 512, cfg.d_inner)).astype(np.float32)
    h0 = rng.standard_normal((1, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    jy, jh = jssm.mamba1_scan(p, jnp.asarray(x), jnp.asarray(h0))
    ty, th = tssm.mamba1_scan(tp, torch.from_numpy(x), torch.from_numpy(h0))
    # 512 dependent fp32 steps compound the rounding: tests/test_models.py's
    # bound for this scan across its chunk boundary
    _close(ty, jy, rtol=2e-4, atol=2e-4)
    _close(th, jh, rtol=2e-4, atol=2e-4)

    Bz, S, H, P, N = 2, 64, 3, 8, 16
    xs = rng.standard_normal((Bz, S, H, P)).astype(np.float32)
    a_log = (-np.abs(rng.standard_normal((Bz, S, H))) * 0.1).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bz, S, N)).astype(np.float32) for _ in range(2))
    jy, jh = jssm.mamba2_ssd(*(jnp.asarray(a) for a in (xs, a_log, Bm, Cm)), chunk=16)
    ty, th = tssm.mamba2_ssd(*(torch.from_numpy(a) for a in (xs, a_log, Bm, Cm)), chunk=16)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "whisper_base", "zamba2_7b"])
def test_params_from_numpy_unstacks_layers(arch):
    cfg, params, model = _pair(arch)
    n_leaves = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_leaves
    assert not any(p.requires_grad for p in model.parameters())
    for key in ("layers", "enc_layers", "dec_layers"):
        if key in params:
            assert isinstance(model[key], torch.nn.ModuleList)
            assert len(model[key]) == jax.tree_util.tree_leaves(params[key])[0].shape[0]
    bf16 = tapi.params_from_numpy(model.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu", dtype=torch.bfloat16)
    dtypes = {name.split(".")[-1]: p.dtype for name, p in bf16.named_parameters()}
    assert dtypes["final_norm" if "final_norm" in dtypes else "dec_norm"] == torch.bfloat16
    for name in set(dtypes) & tapi.FP32_PARAMS:
        assert dtypes[name] == torch.float32, name


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_seeded_init_has_the_reference_structure(arch):
    """The port's own seeded init builds the reference's tree, shape for
    shape, on the generator's device; the same seed gives the same weights."""
    cfg = jconfigs.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: japi.init_params(cfg, jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tcfg = tconfigs.get_smoke_config(arch)
    model = tapi.init_params(tcfg, torch.Generator().manual_seed(0))
    again = tapi.init_params(tcfg, torch.Generator().manual_seed(0))
    got = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = len(parts) > 1 and parts[1].isdigit()
        key = "/".join(parts[:1] + parts[2:]) if stacked else "/".join(parts)
        got.setdefault(key, []).append(tuple(p.shape))
    got = {k: ((len(v),) + v[0]) if k.split("/")[0] in tapi.STACKED else v[0]
           for k, v in got.items()}
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
