"""Whisper-style encoder-decoder backbone ([audio]).

Port of ``repro/models/whisper.py``. The conv/mel frontend is a STUB as in
the reference: callers give precomputed frame embeddings (B, S_enc, D).

  encoder — bidirectional self-attention blocks (the flash_attention kernel,
            non-causal, over ``AUDIO_ENC_FRAMES`` = 1500 frames: not a
            multiple of the kernel's tiles, so its key masking runs here)
  decoder — causal self-attention over a KV cache + cross-attention to
            the encoder output

Decode uses a KV cache for decoder self-attention plus cross-attention K/V
precomputed at prefill, all written in place. Cross-attention is not
causal, so it runs through the kernel at every step (the reference calls
``_sdpa_dense`` there, the same function). Training (``decode_train``,
``loss_fn``) recomputes each encoder and decoder block in backward, as the
reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import functools

import torch

from .. import device as devmod
from . import layers as L
from .config import ArchConfig
from .lm import Model, remat_call, xent


def _enc_block_params(cfg, gen, dtype):
    d = cfg.d_model
    return {
        "ln1": L.ones(d, dtype, gen),
        "attn": L.attention_params(cfg, gen, dtype),
        "ln2": L.ones(d, dtype, gen),
        "mlp": L.mlp_params(cfg, gen, dtype=dtype),
    }


def _dec_block_params(cfg, gen, dtype):
    d = cfg.d_model
    return {
        "ln1": L.ones(d, dtype, gen),
        "self_attn": L.attention_params(cfg, gen, dtype),
        "ln_x": L.ones(d, dtype, gen),
        "cross_attn": L.attention_params(cfg, gen, dtype),
        "ln2": L.ones(d, dtype, gen),
        "mlp": L.mlp_params(cfg, gen, dtype=dtype),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Model:
    d = cfg.d_model
    tree: Dict[str, Any] = {
        "tok_embed": L.normal(gen, (cfg.vocab, d), 0.02, dtype),
        "enc_layers": [_enc_block_params(cfg, gen, dtype) for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_dec_block_params(cfg, gen, dtype) for _ in range(cfg.n_dec_layers)],
        "enc_norm": L.ones(d, dtype, gen),
        "dec_norm": L.ones(d, dtype, gen),
    }
    return Model(tree, cfg)


def _enc_block(cfg, lp, x, positions):
    h, _ = L.gqa_attention(cfg, lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                           positions, causal=False)
    x = x + h
    return x + L.glu_mlp(cfg, lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))


def encode(cfg: ArchConfig, params, frames, remat: bool = True):
    """frames: (B, S_enc, D) precomputed embeddings (frontend stub)."""
    B, S, _ = frames.shape
    positions = torch.arange(S, device=frames.device)[None].expand(B, S)
    x = frames
    for lp in params["enc_layers"]:
        x = remat_call(remat, functools.partial(_enc_block, cfg, lp), x, positions)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attention(cfg, p, x, enc_out):
    """x: (B, S, D) decoder states against the encoder output (the teacher-
    forced decoder's cross-attention)."""
    q = L.split_heads(x @ p["q"], cfg.n_heads)
    k = L.split_heads(enc_out @ p["k"], cfg.n_kv_heads)
    v = L.split_heads(enc_out @ p["v"], cfg.n_kv_heads)
    out = L.sdpa(q, k, v, causal=False)
    return L.o_proj(out, p["o"])


def _dec_block(cfg, lp, x, positions, enc_out):
    h, _ = L.gqa_attention(cfg, lp["self_attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                           positions, causal=True)
    x = x + h
    x = x + _cross_attention(cfg, lp["cross_attn"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps),
                             enc_out)
    return x + L.glu_mlp(cfg, lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))


def decode_train(cfg: ArchConfig, params, tokens, enc_out, remat: bool = True):
    """Teacher-forced decoder pass. tokens: (B, S_dec) -> logits (B, S_dec, V)."""
    B, S = tokens.shape
    # the tied table's two uses, each gradient laid out as the table
    x = L.embed(L.grad_placed(params["tok_embed"]), tokens)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for lp in params["dec_layers"]:
        x = remat_call(remat, functools.partial(_dec_block, cfg, lp), x, positions, enc_out)
    x = L.rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return x @ L.grad_placed(params["tok_embed"]).mT


def loss_fn(cfg: ArchConfig, params, batch, remat: bool = True):
    """batch: dict(frames (B,S_enc,D), tokens (B,S_dec+1))."""
    enc_out = encode(cfg, params, batch["frames"], remat)
    tokens = batch["tokens"]
    logits = decode_train(cfg, params, tokens[:, :-1], enc_out, remat)
    return xent(logits, tokens[:, 1:])


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, device=None):
    dev = devmod.resolve(device)
    Ld, Hkv, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((Ld, batch, max_len, Hkv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((Ld, batch, max_len, Hkv, hd), dtype=dtype, device=dev),
        # cross K/V precomputed at prefill from encoder output
        "xk": torch.zeros((Ld, batch, enc_len, Hkv, hd), dtype=dtype, device=dev),
        "xv": torch.zeros((Ld, batch, enc_len, Hkv, hd), dtype=dtype, device=dev),
    }


def prefill(cfg: ArchConfig, params, frames, cache):
    """Encoder pass + cross-K/V precompute (no decoder tokens yet)."""
    enc_out = encode(cfg, params, frames)
    B = enc_out.shape[0]
    for i, lp in enumerate(params["dec_layers"]):
        p = lp["cross_attn"]
        cache["xk"][i] = L.split_heads(enc_out @ p["k"], cfg.n_kv_heads)
        cache["xv"][i] = L.split_heads(enc_out @ p["v"], cfg.n_kv_heads)
    # no decoder tokens yet: a placeholder logits block keeps the prefill
    # signature of the LM families
    return enc_out.new_zeros((B, 1, cfg.vocab)), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One decoder token. tokens: (B,1)."""
    B = tokens.shape[0]
    x = L.embed(params["tok_embed"], tokens)
    positions = torch.full((B, 1), pos, device=x.device)
    for i, lp in enumerate(params["dec_layers"]):
        h, _ = L.gqa_attention(cfg, lp["self_attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                               positions, causal=True,
                               cache={"k": cache["k"][i], "v": cache["v"][i]}, cache_pos=pos)
        x = x + h
        xq = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
        q = L.split_heads(xq @ lp["cross_attn"]["q"], cfg.n_heads)
        out = L.sdpa(q, cache["xk"][i], cache["xv"][i], causal=False)
        x = x + L.o_proj(out, lp["cross_attn"]["o"])
        x = x + L.glu_mlp(cfg, lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    x = L.rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return x @ params["tok_embed"].mT, cache
