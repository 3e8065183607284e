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

Training: ``remat`` (the reference's ``jax.checkpoint`` per block) becomes
``torch.utils.checkpoint`` per block, non-reentrant, whenever grad is
enabled (``layers.recompute``), and per hybrid group around the blocks'
own; the attention of each recomputed block goes through the kernel again
(``layers.FlashAttention``).

API (the reference's, with a model in place of the pytree):
  init_params(cfg, gen)                         -> model
  forward(cfg, model, tokens)                   -> logits             (train)
  loss_fn(cfg, model, batch)                    -> scalar loss
  init_cache(cfg, batch, max_len)               -> cache
  prefill(cfg, model, tokens, cache)            -> (logits, cache)
  decode_step(cfg, model, cache, tok, pos)      -> (logits, cache)
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from .. import device as devmod
from . import layers as L, ssm as S
from .config import ArchConfig


class Model(nn.Module):
    """A nested dict of tensors as modules: a dict becomes a sub-module, a
    list an ``nn.ModuleList`` (one entry per layer), a tensor a parameter,
    frozen (serving) unless ``requires_grad`` (training). ``p["name"]``
    reads an entry, as in the reference's pytree; :meth:`tree` gives the
    nested dict back, which the optimizers and checkpoints take."""

    def __init__(self, tree: Dict[str, Any], cfg: Optional[ArchConfig] = None,
                 requires_grad: bool = False):
        super().__init__()
        self.cfg = cfg
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Model(value, requires_grad=requires_grad))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(Model(v, requires_grad=requires_grad)
                                                    for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=requires_grad))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> Dict[str, Any]:
        """The parameters as a nested dict (a list per layer stack)."""
        out: Dict[str, Any] = dict(self._parameters)
        for name, m in self._modules.items():
            out[name] = [c.tree() for c in m] if isinstance(m, nn.ModuleList) else m.tree()
        return out


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


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, its activations recomputed in backward
    (``torch.utils.checkpoint``, non-reentrant) when ``remat`` and grad is
    enabled: the reference's ``jax.checkpoint`` around a scanned block."""
    return L.recompute(fn, *args) if remat else fn(*args)


def _blocks(cfg: ArchConfig, params, x, positions, cache=None, cache_pos=None,
            remat: bool = False):
    """Every layer of the stack; with a cache, filled (prefill, cache_pos
    0) or extended (decode) in place; without one, each block under
    :func:`remat_call`. The layers go through ``layers.scan`` (the
    reference's ``lax.scan``s), one trip per layer, or per group of
    ``attn_every`` SSM layers and the shared attention block (hybrid), so
    the trips are alike; a hybrid stack's tail layers follow. With remat, a
    hybrid group is recomputed as a whole around its blocks' own remat, the
    shared attention block inside it with no checkpoint of its own, as the
    reference checkpoints ``group`` around ``block`` (reference
    lm.py:170-188): the forward keeps each group's input, not each
    block's; the tail layers keep their own. The dry-run cuts the layers
    short only where no gradient is taken: a skipped layer's parameters
    would get none."""
    remat = remat and cache is None
    layers = params["layers"]
    cut = not torch.is_grad_enabled()
    if cfg.family in ("dense", "vlm", "moe"):
        def layer(x, i):
            return remat_call(remat, functools.partial(_attn_block, cfg, layers[i]), x, positions,
                              _layer(cache, i), cache_pos), None

        return L.scan(layer, x, len(layers), cut)[0]
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(cfg.family)
    states = cache if cache is None or cfg.family == "ssm" else cache["ssm"]

    def ssm(x, i):
        return remat_call(remat, functools.partial(_ssm_block, cfg, layers[i]), x, states, i)

    if cfg.family == "ssm":
        return L.scan(lambda x, i: (ssm(x, i), None), x, len(layers), cut)[0]
    k = cfg.attn_every

    def group(x, g):
        # attn_every ssm blocks, then the shared attention block with this
        # group's own KV history
        def body(x):
            for i in range(g * k, (g + 1) * k):
                x = ssm(x, i)
            ac = None if cache is None else {"k": cache["attn_k"][g], "v": cache["attn_v"][g]}
            return _attn_block(cfg, params["shared_attn"], x, positions, ac, cache_pos)

        return remat_call(remat, body, x), None

    x = L.scan(group, x, len(layers) // k, cut)[0]
    for i in range(len(layers) // k * k, len(layers)):
        x = ssm(x, i)
    return x


def _head(cfg: ArchConfig, params):
    return params["embed"].mT if cfg.tie_embeddings else params["lm_head"]


def _logits(cfg: ArchConfig, params, x):
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps) @ _head(cfg, params)


def _positions(B, S, start, device):
    return (torch.arange(S, device=device) + start)[None].expand(B, S)


# ---------------------------------------------------------------------------
# forward (train / no cache)
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params, tokens, remat: bool = True,
            input_embeds: Optional[torch.Tensor] = None, return_hidden: bool = False):
    """tokens: (B,S) int (or ``input_embeds`` (B,S,D) for frontend stubs) ->
    logits (B,S,V), and the final-norm hidden states with ``return_hidden``."""
    x = input_embeds if input_embeds is not None else L.embed(params["embed"], tokens)
    x = L.hint(x, L.DP, None, None)                              # reference lm.py:152
    B, Sq = x.shape[:2]
    x = _blocks(cfg, params, x, _positions(B, Sq, 0, x.device), remat=remat)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.hint(hidden @ _head(cfg, params), L.DP, None, "model")   # reference lm.py:199
    return (logits, hidden) if return_hidden else logits


def loss_fn(cfg: ArchConfig, params, batch, remat: bool = True):
    """batch: dict(tokens (B,S+1)) -> mean next-token cross-entropy.

    With ``cfg.mtp_depth``, adds the DeepSeek-V3 multi-token-prediction
    auxiliary loss (predict t+2 from the backbone state at t).
    """
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    embeds = batch.get("input_embeds")
    logits, hidden = forward(cfg, params, inp, remat=remat, return_hidden=True,
                             input_embeds=None if embeds is None else embeds[:, :-1])
    loss = xent(logits, tgt)
    if cfg.mtp_depth:
        # MTP: at position t, combine h_t with emb(token_{t+1}) to predict
        # token_{t+2} through one extra block (DeepSeek-V3 Section 2.2)
        mp = params["mtp"]
        B, Sq = inp.shape
        h = hidden[:, : Sq - 1]                                 # (B,S-1,D)
        nxt = L.embed(params["embed"], inp[:, 1:]).to(h.dtype)           # emb(t+1)
        z = torch.cat([h, nxt], dim=-1) @ mp["proj"]
        z = _attn_block(cfg, mp["block"], z, _positions(B, Sq - 1, 0, z.device))
        z = L.rms_norm(z, mp["norm"], cfg.norm_eps)
        loss = loss + 0.3 * xent(z @ _head(cfg, params), tgt[:, 1:])   # token t+2
    return loss


def xent(logits, targets):
    """Mean cross-entropy in fp32: logsumexp over the vocabulary minus the
    target logit (the reference takes it by a one-hot contraction, which
    selects the same value exactly)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)                       # (B,S)
    if isinstance(logits, DTensor):
        # the reference's one-hot contraction (lm.py:246), which stays
        # sharded over the vocab ('model') axis; a gather there leaves a
        # masked partial sum that DTensor's redistribution misapplies
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        onehot = L.hint((targets.long()[..., None] == vocab).to(logits.dtype),
                        L.DP, None, "model")
        tgt_logit = (logits * onehot).sum(dim=-1)
    else:
        tgt_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt_logit).mean()


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
    x = L.embed(params["embed"], tokens)
    x = _blocks(cfg, params, x, _positions(B, Sq, 0, x.device), cache, 0)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One decode step. tokens: (B, 1); pos: the current length. Attention
    archs attend over the KV cache; SSM archs update O(1) state. Returns
    (logits (B,1,V), cache)."""
    x = L.embed(params["embed"], tokens)
    x = _blocks(cfg, params, x, _positions(x.shape[0], 1, pos, x.device), cache, pos)
    return _logits(cfg, params, x), cache
