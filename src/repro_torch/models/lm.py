"""Unified language-model builder for the decoder-only architecture families.

Port of ``repro/models/lm.py``:

* dense / vlm     — pre-norm GQA transformer (rotary, GLU MLP)
* moe             — attention (GQA or MLA) + MoE FFN
* ssm             — Mamba1 stack (attention-free)
* hybrid          — Mamba2 stack with a SHARED attention+MLP block applied
                    every ``attn_every`` layers (Zamba2's weight-shared design)
* audio (whisper) — encoder-decoder, see ``whisper.py``

The model is an ``nn.Module`` (:class:`Model`) holding the reference's
parameter tree, with the per-layer blocks in an ``nn.ModuleList`` instead of
the reference's stacked ``(L, ...)`` arrays, so the layers run as a Python
loop instead of a ``lax.scan``: one loop (``_blocks``) serves ``forward``,
``prefill`` and ``decode_step`` for every family, in place of the
reference's per-function scans, its hybrid group reshapes and
``_hybrid_prefill``. Parameters are frozen (``requires_grad`` False): this
is the serving path.

The cache is a dict of preallocated tensors with the reference's shapes
(a leading layer axis), written **in place** by ``prefill`` and
``decode_step`` to save memory; the reference's update is functional. Both
return the same dict.

API (the reference's, with a model in place of the pytree):
  init_params(cfg, gen)                         -> model
  forward(cfg, model, tokens)                   -> logits
  init_cache(cfg, batch, max_len)               -> cache
  prefill(cfg, model, tokens, cache)            -> (logits, cache)
  decode_step(cfg, model, cache, tok, pos)      -> (logits, cache)

``loss_fn``/``xent`` and the multi-token-prediction loss wait for the
training slice; the MTP block's parameters are built already, so the model
holds the reference's whole tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import device as devmod
from . import layers as L, ssm as S
from .config import ArchConfig


class Model(nn.Module):
    """A nested dict of tensors as modules: a dict becomes a sub-module, a
    list an ``nn.ModuleList`` (one entry per layer), a tensor a frozen
    parameter. ``p["name"]`` reads an entry, as in the reference's pytree."""

    def __init__(self, tree: Dict[str, Any], cfg: Optional[ArchConfig] = None):
        super().__init__()
        self.cfg = cfg
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Model(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(Model(v) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Dict[str, Any]:
    """One layer's params."""
    d = cfg.d_model
    if cfg.family in ("dense", "vlm", "moe"):
        ffn = ("moe", L.moe_params(cfg, gen, dtype)) if cfg.family == "moe" \
            else ("mlp", L.mlp_params(cfg, gen, dtype=dtype))
        return {
            "ln1": L.ones(d, dtype, gen),
            "attn": L.attention_params(cfg, gen, dtype),
            "ln2": L.ones(d, dtype, gen),
            ffn[0]: ffn[1],
        }
    if cfg.family == "ssm":
        return {"ln1": L.ones(d, dtype, gen), "ssm": S.mamba1_params(cfg, gen, dtype)}
    if cfg.family == "hybrid":
        return {"ln1": L.ones(d, dtype, gen), "ssm": S.mamba2_params(cfg, gen, dtype)}
    raise ValueError(cfg.family)


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Model:
    """Seeded weights on the generator's device."""
    d = cfg.d_model
    tree: Dict[str, Any] = {
        "embed": L.normal(gen, (cfg.vocab, d), 0.02, dtype),
        "final_norm": L.ones(d, dtype, gen),
        "layers": [_block_params(cfg, gen, dtype) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(gen, d, cfg.vocab, dtype)
    if cfg.family == "hybrid":
        # Zamba2 shared attention block (ONE set of weights, reused)
        tree["shared_attn"] = {
            "ln1": L.ones(d, dtype, gen),
            "attn": L.attention_params(cfg, gen, dtype),
            "ln2": L.ones(d, dtype, gen),
            "mlp": L.mlp_params(cfg, gen, dtype=dtype),
        }
    if cfg.mtp_depth:
        # DeepSeek-V3 multi-token prediction: one extra transformer block +
        # projection predicting token t+2 from [h_t ; emb(t+1)]
        tree["mtp"] = {
            "proj": L.dense_init(gen, 2 * d, d, dtype),
            "block": _block_params(cfg, gen, dtype),
            "norm": L.ones(d, dtype, gen),
        }
    return Model(tree, cfg)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _layer(cache, i):
    """Layer ``i``'s views of a stacked cache (None stays None)."""
    return None if cache is None else {k: v[i] for k, v in cache.items()}


def _attn_block(cfg, p, x, positions, cache=None, cache_pos=None, causal=True):
    attn_fn = L.mla_attention if cfg.use_mla else L.gqa_attention
    h, _ = attn_fn(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                   positions, causal=causal, cache=cache, cache_pos=cache_pos)
    x = x + h
    hn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        return x + L.moe_ffn(cfg, p["moe"], hn)
    return x + L.glu_mlp(cfg, p["mlp"], hn)


def _ssm_block(cfg, p, x, states=None, i=None):
    """One SSM layer; with ``states`` (the stacked cache), reads layer i's
    state and writes the new one back in place."""
    fn = S.mamba1_block if cfg.ssm_variant == "mamba1" else S.mamba2_block
    h, new = fn(cfg, p["ssm"], L.rms_norm(x, p["ln1"], cfg.norm_eps), _layer(states, i))
    if states is not None:
        for name, t in new.items():
            states[name][i].copy_(t)
    return x + h


def _blocks(cfg: ArchConfig, params, x, positions, cache=None, cache_pos=None):
    """Every layer of the stack; with a cache, filled (prefill, cache_pos
    0) or extended (decode) in place."""
    if cfg.family in ("dense", "vlm", "moe"):
        for i, lp in enumerate(params["layers"]):
            x = _attn_block(cfg, lp, x, positions, _layer(cache, i), cache_pos)
        return x
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(cfg.family)
    states = cache if cache is None or cfg.family == "ssm" else cache["ssm"]
    for i, lp in enumerate(params["layers"]):
        x = _ssm_block(cfg, lp, x, states, i)
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            # groups of attn_every ssm blocks, each followed by the shared
            # attention block with its own KV history
            g = i // cfg.attn_every
            ac = None if cache is None else {"k": cache["attn_k"][g], "v": cache["attn_v"][g]}
            x = _attn_block(cfg, params["shared_attn"], x, positions, ac, cache_pos)
    return x


def _logits(cfg: ArchConfig, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].mT if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _positions(B, S, start, device):
    return (torch.arange(S, device=device) + start)[None].expand(B, S)


# ---------------------------------------------------------------------------
# forward (no cache)
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params, tokens):
    """tokens: (B,S) int -> logits (B,S,V)."""
    B, Sq = tokens.shape
    x = params["embed"][tokens]
    return _logits(cfg, params, _blocks(cfg, params, x, _positions(B, Sq, 0, x.device)))


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    dev = devmod.resolve(device)
    Lc = cfg.n_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.use_mla:
            return {"c_kv": zeros(Lc, batch, max_len, cfg.kv_lora_rank),
                    "k_rope": zeros(Lc, batch, max_len, cfg.rope_head_dim)}
        return {"k": zeros(Lc, batch, max_len, cfg.n_kv_heads, cfg.hd),
                "v": zeros(Lc, batch, max_len, cfg.n_kv_heads, cfg.hd)}
    if cfg.family in ("ssm", "hybrid"):
        init = S.mamba1_init_state if cfg.family == "ssm" else S.mamba2_init_state
        states = {k: zeros(Lc, *a.shape, dt=a.dtype)
                  for k, a in init(cfg, batch, dtype, dev).items()}
        if cfg.family == "ssm":
            return states
        # the shared attention block has ONE weight set but is applied once
        # per group — each application needs its own KV history
        ng = cfg.n_layers // cfg.attn_every
        return {"ssm": states,
                "attn_k": zeros(ng, batch, max_len, cfg.n_kv_heads, cfg.hd),
                "attn_v": zeros(ng, batch, max_len, cfg.n_kv_heads, cfg.hd)}
    raise ValueError(cfg.family)


def prefill(cfg: ArchConfig, params, tokens, cache):
    """Run the prompt once, filling the cache. tokens: (B,S). Returns the
    last position's logits (B,1,V) and the cache."""
    B, Sq = tokens.shape
    x = params["embed"][tokens]
    x = _blocks(cfg, params, x, _positions(B, Sq, 0, x.device), cache, 0)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One decode step. tokens: (B, 1); pos: the current length. Attention
    archs attend over the KV cache; SSM archs update O(1) state. Returns
    (logits (B,1,V), cache)."""
    x = params["embed"][tokens]
    x = _blocks(cfg, params, x, _positions(x.shape[0], 1, pos, x.device), cache, pos)
    return _logits(cfg, params, x), cache
